"""Flat (exact) index (paper §III-C) and the port's one top-k primitive.

`topk_smallest` is the tie-stable top-k every part of the port uses: the k
smallest entries of each row, ascending, equal values in index order —
what ``lax.top_k(-x, k)`` gives in the JAX package (signed zeros included), where ``torch.topk``
leaves the order of ties unspecified.  It selects on a unique 64-bit key
(order-preserving float bits above the column index) with ``torch.topk``,
so it never sorts a whole row.

`scan_topk` is the chunked streaming top-k every scan of the port runs
(mask, ``base_index``): the exact flat scan, and the PQ and BQ flat routes
whose blocks come from the ``pq_adc`` and ``hamming`` kernels.
`flat_search` is the exact scan: each block comes from the metric registry,
so on the card from the ``l2_distance`` kernel (B5) in l2 or dot mode.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

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


def scan_topk(dist_fn: Callable[[int, int], torch.Tensor], n: int, k: int,
              chunk: Optional[int] = None,
              mask: Optional[torch.Tensor] = None,
              base_index: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of a (Q, n) distance matrix that ``dist_fn(lo, hi)``
    gives one column block [lo, hi) at a time, ``chunk`` columns a block
    (None: one block).  Columns where ``mask`` is False score +inf.  The
    result equals one `topk_smallest` over the whole matrix, ties included:
    each block's top-k is merged behind the lower columns already kept.

    Returns (distances (Q, k) ascending, indices + base_index (Q, k) int32).
    """
    k = min(k, n)
    step = n if chunk is None else max(1, chunk)
    best = None
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        d = dist_fn(lo, hi)
        if mask is not None:
            d = d.masked_fill(~mask[None, lo:hi], float("inf"))
        cd, sel = topk_smallest(d, min(k, hi - lo))
        cand = (cd, sel + lo)
        best = cand if best is None else merge_topk(*best, *cand, k)
    d, idx = best
    return d, (idx + base_index).to(torch.int32)


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
        transient (Q, chunk) distance matrix).  Results equal the unchunked
        scan's, ties included.
      mask: optional (N,) bool — MEVS metadata filter; False rows are
        excluded (distance = +inf).
      base_index: offset added to returned indices (shard-local -> global).

    Returns:
      (distances (Q,k) ascending, indices (Q,k) int32).
    """
    pair = get_metric(metric)
    return scan_topk(lambda lo, hi: pair(queries, corpus[lo:hi]),
                     corpus.shape[0], k, chunk=chunk, mask=mask,
                     base_index=base_index)
