"""Exact k-nearest-neighbour search in plain PyTorch: the reference of every
vector-search configuration.

Distances (a configuration's ``distance``), as the engine reports them:

- ``sq_l2``: the squared Euclidean distance;
- ``neg_cosine``: minus the cosine of the angle (``-q.x`` on unit rows).

`exact_topk` finds each query's k nearest in two passes.  The first keeps,
block of rows by block, the ``k + MARGIN`` smallest distances of the norm
expansion in float32 with TF32 off; the second works those candidates'
distances out again in float64 and keeps the k smallest, ties to the lowest
id.  A true neighbour misses the first pass only where more than MARGIN
rows lie within float32's rounding of it.  `candidates` alone, with
``tf32=True``, is the control: the reference at the precision below the
configuration's float32.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: first-pass candidates a query keeps beyond k
MARGIN = 22
#: bytes of one (queries, rows) block of first-pass distances
BLOCK_BYTES = 1 << 31
#: queries a block
QUERY_BLOCK = 1024


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def pair_distance64(distance: str, q: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """(..., D) x (..., D) -> (...) float64 distances of paired rows."""
    q, x = q.double(), x.double()
    if distance == "sq_l2":
        return ((q - x) ** 2).sum(-1)
    if distance == "neg_cosine":
        return -(unit(q) * unit(x)).sum(-1)
    raise ValueError(f"unknown distance {distance!r}")


def pair_scale64(distance: str, q: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """The size a distance's rounding scales with: |q|·|x| for ``sq_l2``
    (the norm expansion's cross term), 1 for ``neg_cosine`` (unit rows)."""
    if distance == "sq_l2":
        return q.double().norm(dim=-1) * x.double().norm(dim=-1)
    return torch.ones(q.shape[:-1], dtype=torch.float64, device=q.device)


def _block_distances(distance: str, q: torch.Tensor, x: torch.Tensor,
                     q_sq: torch.Tensor) -> torch.Tensor:
    """float32 (Q, R) distances of the norm expansion; q and x already unit
    rows for ``neg_cosine``."""
    dot = q @ x.T
    if distance == "neg_cosine":
        return dot.neg_()
    return (q_sq[:, None] + (x * x).sum(1)[None, :]).sub_(dot, alpha=2.0) \
        .clamp_min_(0.0)


def candidates(queries: torch.Tensor, corpus: torch.Tensor, k: int,
               distance: str, tf32: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest float32 distances of each query over the corpus, by
    the norm expansion in float32, its products in TF32 where ``tf32``:
    (distances (Q, k) ascending, int64 ids)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return _candidates(queries, corpus, k, distance)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _candidates(queries, corpus, k, distance):
    n = corpus.shape[0]
    kk = min(k, n)
    rows_per_block = max(kk, BLOCK_BYTES // (4 * QUERY_BLOCK))
    out_d, out_i = [], []
    for qlo in range(0, queries.shape[0], QUERY_BLOCK):
        q = queries[qlo: qlo + QUERY_BLOCK].float()
        if distance == "neg_cosine":
            q = unit(q)
        q_sq = (q * q).sum(1)
        best_d = best_i = None
        for lo in range(0, n, rows_per_block):
            x = corpus[lo: lo + rows_per_block].float()
            if distance == "neg_cosine":
                x = unit(x)
            d = _block_distances(distance, q, x, q_sq)
            bd, bi = torch.topk(d, min(kk, d.shape[1]), dim=1, largest=False)
            bi = bi + lo
            if best_d is not None:
                bd, bi = torch.cat([best_d, bd], 1), torch.cat([best_i, bi], 1)
                bd, sel = torch.topk(bd, kk, dim=1, largest=False)
                bi = bi.gather(1, sel)
            best_d, best_i = bd, bi
            del d
        best_d, order = torch.sort(best_d, dim=1, stable=True)
        out_d.append(best_d)
        out_i.append(best_i.gather(1, order))
    return torch.cat(out_d), torch.cat(out_i)


def rerank64(queries: torch.Tensor, rows: torch.Tensor,
             ids: torch.Tensor, k: int,
             distance: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates (Q, C) int64 ids of ``rows`` -> their k smallest float64
    distances, ties to the lowest id."""
    x = rows[ids]
    d = pair_distance64(distance, queries[:, None, :].expand_as(x), x)
    order = torch.argsort(ids, dim=1, stable=True)
    d, ids = d.gather(1, order), ids.gather(1, order)
    d, order = torch.sort(d, dim=1, stable=True)
    return d[:, :k], ids.gather(1, order)[:, :k]


def exact_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
               distance: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's k nearest rows of ``corpus``: (float64 distances (Q, k)
    ascending, int64 ids), ties to the lowest id."""
    _, cand = candidates(queries, corpus, k + MARGIN, distance)
    return rerank64(queries, corpus, cand, k, distance)
