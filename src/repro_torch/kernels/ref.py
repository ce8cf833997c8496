"""Plain PyTorch versions of the port's CUDA kernels (the correctness contract).

Each function is the batched form of its counterpart in the JAX package's
``repro.kernels.ref``: the JAX package calls its kernels under ``vmap`` (one
query, one prune node at a time), the port passes the batch axis to the
kernel.  The CPU tests run these; ``chip_smoke.py`` holds each CUDA kernel to
its plain version on the card.  Nothing on the main path calls the kernels'
plain versions when the tensors lie on a card; only ``gathered_dists``, the
row-wise arithmetic they share, is also plain code of the main path.
"""

from __future__ import annotations

import torch


def gathered_dists(q: torch.Tensor, rows: torch.Tensor,
                   metric: str) -> torch.Tensor:
    """q (Q, D) vs its own gathered rows (Q, M, D) -> (Q, M) raw scores
    (smaller == closer): diff-square-sum for ``l2``, ``-q·x`` otherwise.

    The arithmetic of ``beam_gather``'s plain versions below.  The upper-layer
    descent and the bulk builder's row distances, plain code in the JAX
    package as well, call it directly on rows they gathered themselves.
    """
    if metric == "l2":
        d = rows - q[:, None, :]
        return (d * d).sum(-1)
    return -torch.bmm(rows, q[:, :, None])[..., 0]


def beam_gather_l2_ref(q: torch.Tensor, ids: torch.Tensor,
                       corpus: torch.Tensor) -> torch.Tensor:
    """q (Q, D) × ids (Q, L) × corpus (N, D) -> (Q, L) squared L2.

    Diff-square-sum, not the norm expansion: the same float ops as the
    single-pop traversal, so width 1 reproduces it.
    """
    return gathered_dists(q, corpus[ids.long()], "l2")


def beam_gather_dot_ref(q: torch.Tensor, ids: torch.Tensor,
                        corpus: torch.Tensor) -> torch.Tensor:
    """q (Q, D) × ids (Q, L) × corpus (N, D) -> (Q, L) negated inner product."""
    return gathered_dists(q, corpus[ids.long()], "dot")


def pair_gather_l2_ref(ids: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """ids (B, C) × corpus (N, D) -> (B, C, C) pairwise squared L2 among
    each node's gathered candidate rows, norm-expansion form clamped at 0."""
    rows = corpus[ids.long()]                       # (B, C, D)
    g = torch.bmm(rows, rows.transpose(1, 2))
    nn = (rows * rows).sum(-1)
    return (nn[:, :, None] + nn[:, None, :] - 2.0 * g).clamp_min(0.0)


def pair_gather_dot_ref(ids: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """ids (B, C) × corpus (N, D) -> (B, C, C) negated pairwise inner products."""
    rows = corpus[ids.long()]
    return -torch.bmm(rows, rows.transpose(1, 2))
