"""Distance metrics (paper §I, §III-A) in PyTorch: cosine (the default), L2,
inner product and Hamming over packed codes, as in the JAX package's
``repro.core.distances``.

Queries ``(Q, D)`` against a corpus ``(N, D)`` give a ``(Q, N)`` distance
matrix; smaller is closer for every metric (similarities are negated), so
top-k code is metric-agnostic.  The pairwise l2 and dot scans run the
``l2_distance`` kernel (B5's matrix entry) on the card through
``kernels.ops``, cosine runs it in dot mode on normalized rows, and Hamming
runs the ``hamming`` kernel; CPU tensors take the kernels' plain versions.
The engine's exact scans (the flat index, the low-selectivity flat route,
the delta segment) go through ``core.flat.flat_search``: on the CPU over
this registry, on the card through B5's fused entry with the same
formulas.  `rowwise` applies the same formulas to each
query's own gathered rows, batched (the exact rescore): a plain
``torch.bmm`` in full fp32, as the JAX package leaves it outside Pallas.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..kernels import ops
from ..kernels.ref import topk_smallest

#: Registry of metric name -> pairwise fn (queries (Q,D), corpus (N,D)) -> (Q,N)
_METRICS: Dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {}


def register_metric(name: str):
    def deco(fn):
        _METRICS[name] = fn
        return fn

    return deco


def get_metric(name: str) -> Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor]:
    try:
        return _METRICS[name]
    except KeyError:
        raise ValueError(f"unknown metric {name!r}; have {sorted(_METRICS)}")


def available_metrics():
    return sorted(_METRICS)


def l2_norm_sq(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    x = x.float()
    return (x * x).sum(dim)


def normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize rows (cosine preprocessing)."""
    x = x.float()
    n = torch.sqrt(torch.clamp_min(l2_norm_sq(x), eps))
    return x / n[..., None]


@register_metric("l2")
def pairwise_l2(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances, ‖q‖² + ‖x‖² − 2·q·x clamped at 0."""
    return ops.l2_distances(queries, corpus)


@register_metric("dot")
def pairwise_dot(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Negative inner product (so smaller == more similar)."""
    return ops.dot_distances(queries, corpus)


@register_metric("cosine")
def pairwise_cosine(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Cosine *distance* = 1 - cosine similarity. Default Quantixar metric."""
    return 1.0 + pairwise_dot(normalize(queries), normalize(corpus))


@register_metric("hamming")
def pairwise_hamming(q_codes: torch.Tensor,
                     x_codes: torch.Tensor) -> torch.Tensor:
    """Hamming distance between packed binary codes: ``(Q, W)`` × ``(N, W)``
    int32 words holding the uint32 bits (``core/bq.py``'s layout) ->
    ``(Q, N)`` int32 bit-difference counts."""
    return ops.hamming_distances(q_codes.contiguous(), x_codes.contiguous())


# ---------------------------------------------------------------------------
# Single-pair conveniences
# ---------------------------------------------------------------------------

def point_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    d = q.float() - x.float()
    return (d * d).sum(-1)


def point_cosine(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return 1.0 - (normalize(q) * normalize(x)).sum(-1)


def point_dot(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return -(q.float() * x.float()).sum(-1)


POINT_METRICS = {"l2": point_l2, "cosine": point_cosine, "dot": point_dot}


def brute_force_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                     metric: str = "cosine"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the whole (Q, N) matrix of the registry's metric:
    the paper's Flat Index primitive.  Returns (distances (Q, k) ascending,
    indices (Q, k) int32), ties to the lowest index."""
    d, idx = topk_smallest(get_metric(metric)(queries, corpus), k)
    return d, idx.to(torch.int32)


def rowwise(metric: str, queries: torch.Tensor,
            rows: torch.Tensor) -> torch.Tensor:
    """Each query (Q, D) against its own rows (Q, M, D) -> (Q, M), by the
    registry metric's formula: what ``get_metric(metric)(q[i:i+1],
    rows[i])`` gives query by query, in one batched product."""
    if metric == "cosine":
        queries, rows = normalize(queries), normalize(rows)
    q, x = queries.float(), rows.float()
    dot = torch.bmm(x, q[:, :, None])[..., 0]
    if metric == "l2":
        d = l2_norm_sq(q)[:, None] + l2_norm_sq(x) - 2.0 * dot
        return torch.clamp_min(d, 0.0)
    if metric == "cosine":
        return 1.0 + -dot
    if metric == "dot":
        return -dot
    raise ValueError(f"unknown metric {metric!r}; have {sorted(_METRICS)}")
