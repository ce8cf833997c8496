"""Flat (exact) index (paper §III-C) and the port's one top-k primitive.

`topk_smallest` is the tie-stable top-k every part of the port uses: the k
smallest entries of each row, ascending, equal values in index order —
what ``lax.top_k(-x, k)`` gives in the JAX package (signed zeros included), where ``torch.topk``
leaves the order of ties unspecified.  It selects on a unique 64-bit key
(order-preserving float bits above the column index) with ``torch.topk``,
so it never sorts a whole row.

`flat_search` is the exact scan (mask, chunked streaming top-k,
``base_index``) as plain torch: the JAX package leaves this product to XLA,
and the port leaves it to ``torch.matmul``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .distances import get_metric


def topk_smallest(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries along the last dim of float x, ascending, ties
    broken by the lowest index.  Returns (values, int64 indices)."""
    x = x.float()
    # float bits -> int32 in the same order, -0.0 below +0.0 as in XLA's
    # total order; NaN above +inf
    bits = x.view(torch.int32)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    col = torch.arange(x.shape[-1], device=x.device, dtype=torch.int64)
    key = (ordered << 32) | col
    _, pos = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    return x.gather(-1, pos), pos


def merge_topk(d_a: torch.Tensor, i_a: torch.Tensor, d_b: torch.Tensor,
               i_b: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two (Q, ka)/(Q, kb) candidate sets into the best-k (ascending);
    on equal distances the first set's entries come first."""
    d = torch.cat([d_a, d_b], dim=-1)
    i = torch.cat([i_a, i_b], dim=-1)
    top, sel = topk_smallest(d, k)
    return top, i.gather(-1, sel)


def flat_search(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                metric: str = "cosine", chunk: Optional[int] = None,
                mask: Optional[torch.Tensor] = None,
                base_index: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k scan.

    Args:
      queries: (Q, D).
      corpus: (N, D), on the queries' device.
      k: neighbours to return.
      metric: registry name.
      chunk: if set, scan the corpus in chunks of this many rows (bounds the
        transient (Q, chunk) distance matrix).  Finite results equal the
        unchunked scan's, ties included.
      mask: optional (N,) bool — MEVS metadata filter; False rows are
        excluded (distance = +inf).
      base_index: offset added to returned indices (shard-local -> global).

    Returns:
      (distances (Q,k) ascending, indices (Q,k) int32).
    """
    pair = get_metric(metric)
    n = corpus.shape[0]
    k = min(k, n)

    if chunk is None or chunk >= n:
        d = pair(queries, corpus)
        if mask is not None:
            d = d.masked_fill(~mask[None, :], float("inf"))
        d, idx = topk_smallest(d, k)
        return d, (idx + base_index).to(torch.int32)

    q_count = queries.shape[0]
    best_d = torch.full((q_count, k), float("inf"), device=queries.device)
    best_i = torch.full((q_count, k), -1, dtype=torch.int32,
                        device=queries.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        d = pair(queries, corpus[lo:hi])
        if mask is not None:
            d = d.masked_fill(~mask[None, lo:hi], float("inf"))
        cd, sel = topk_smallest(d, min(k, hi - lo))
        ci = (sel + lo + base_index).to(torch.int32)
        best_d, best_i = merge_topk(best_d, best_i, cd, ci, k)
    return best_d, best_i
