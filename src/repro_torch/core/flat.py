"""Flat (exact) index (paper §III-C) and the port's one top-k primitive.

`topk_smallest` (defined beside the kernels' plain versions, in
``kernels/ref.py``) is the tie-stable top-k every part of the port uses:
the k smallest entries of each row, ascending, equal values in index order
— what ``lax.top_k(-x, k)`` gives in the JAX package (signed zeros
included), where ``torch.topk`` leaves the order of ties unspecified.  It
selects on a unique 64-bit key (order-preserving float bits above the
column index) with ``torch.topk``, so it never sorts a whole row.

`scan_topk` is the chunked streaming top-k over blocks of a distance
matrix (mask, ``base_index``): the PQ and BQ flat routes, whose blocks come
from the ``pq_adc`` and ``hamming`` kernels, and the exact scan on the CPU
or past `FUSED_MAX_K`.

`flat_search` is the exact scan.  On the card, for l2, dot and cosine with
k <= `FUSED_MAX_K` (100), it is one launch of B5's fused entry
(``kernels/l2.py:l2_topk``) over the whole corpus: the cross term in 3xTF32
on the tensor cores and a per-block top-k on the same 64-bit key, so the
(Q, N) matrix is never written and no chunk loop runs; it returns what the
chunked scan over B5's matrix entry returns, bit for bit.  On the CPU, for
other metrics, for larger k, and on the card for a corpus of at most
`MATRIX_MAX_N` (8,192) rows at a k past the fused entry's fast k
(`fused_fast_k`), it is `scan_topk` over the metric registry (on the card,
the matrix entry ``l2_distance``), where those are faster: the fused entry
takes k <= 256, but past its fast k its lists' insertions cost more than
the matrix and the chunked top-k, at any N past k ~100 and on a small
corpus past the fast k.  Both routes return the same bits.  Cosine normalizes the rows, the
corpus once per call or not at all where the caller passes its cached unit
rows (``unit_corpus``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from ..kernels import ops
from ..kernels.ref import topk_smallest
from .distances import get_metric, normalize, pairwise_dot

#: metrics whose exact scan the fused kernel runs on the card
_FUSED = ("l2", "dot", "cosine")
#: the largest k whose exact scan takes the fused kernel on the card.  Past
#: 16 (Q > 32) or 64 (Q <= 32) a block's lists leave shared memory and each
#: insertion walks global memory.  On an H100 at 1,024 x 1M x 128 the fused
#: scan takes 5.8 ms at k = 16, 31 at 64, 61 at 100 and 314 at 256, the
#: chunked matrix route 62-64 throughout; at Q = 32, 0.74 / 3.5 / 9.1 / 42
#: ms against 7.5-11.5 (chip_smoke.py's topk_k_sweep).  Past it, the route.
FUSED_MAX_K = 100
#: the largest corpus that takes the route (one matrix and its top-k)
#: rather than the fused entry at a k past `fused_fast_k`.  On an H100
#: (chip_smoke.py's small_topk_sweep, device ms) at Q = 1,024 the route
#: takes 0.14-0.16 ms over 1,024 rows and 0.58-0.61 over 8,192 at any k,
#: the fused entry 0.82-8.0 and 1.27-7.7 from k = 17 to 100; over 65,536
#: rows the route's top-k alone costs more (3.8 ms) and the fused entry
#: wins at k = 17 (2.1), so the crossover lies above 8,192 rows.
MATRIX_MAX_N = 8192


def fused_fast_k(nq: int) -> int:
    """The largest k whose lists the fused entry keeps in shared memory:
    64 for Q <= 32 (one block takes every query), 16 above.  A copy of
    ``csrc/l2_distance.cu``'s limit (``kernels.l2.fast_k`` reads it from
    the library), kept here so that the dispatch needs no library; the two
    must change together (a ``cuda`` test and chip_smoke.py hold them
    equal)."""
    return 64 if nq <= 32 else 16


def takes_fused(metric: str, nq: int, n: int, k: int) -> bool:
    """Whether an exact scan of nq queries over n rows for their k nearest
    takes the fused entry on the card (else the matrix route)."""
    kk = min(k, n)
    return (metric in _FUSED and 0 < kk <= FUSED_MAX_K
            and not (n <= MATRIX_MAX_N and kk > fused_fast_k(nq)))


def merge_topk(d_a: torch.Tensor, i_a: torch.Tensor, d_b: torch.Tensor,
               i_b: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two (Q, ka)/(Q, kb) candidate sets into the best-k (ascending;
    all ka + kb where that is fewer); on equal distances the first set's
    entries come first."""
    d = torch.cat([d_a, d_b], dim=-1)
    i = torch.cat([i_a, i_b], dim=-1)
    top, sel = topk_smallest(d, min(k, d.shape[-1]))
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
                mask: Optional[torch.Tensor] = None, base_index: int = 0,
                unit_corpus: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k scan.

    Args:
      queries: (Q, D).
      corpus: (N, D), on the queries' device.
      k: neighbours to return.
      metric: registry name.
      chunk: if set, scan the corpus in chunks of this many rows (bounds the
        transient (Q, chunk) distance matrix) where `scan_topk` runs; the
        fused kernel has no such matrix.  The distances and the ids of
        finite slots equal the unchunked scan's, ties included.  Where
        ``chunk < N``, slots left at +inf (fewer than k rows pass the mask)
        come back as -1, without ``base_index``, as the reference's chunked
        scan returns them; unchunked (None or >= N), they carry masked
        rows' ids, as the reference's unchunked scan does.
      mask: optional (N,) bool — MEVS metadata filter; False rows are
        excluded (distance = +inf).
      base_index: offset added to returned indices (shard-local -> global).
      unit_corpus: cosine only: the corpus rows are already unit
        (``normalize``, as the engine caches them) and are not normalized
        again.  Otherwise the fused kernel's cosine scan normalizes the
        whole corpus, a transient (N, D) copy, on every call.

    Returns:
      (distances (Q,k) ascending, indices (Q,k) int32).
    """
    kk = min(k, corpus.shape[0])
    if corpus.device.type == "cuda" and takes_fused(
            metric, queries.shape[0], corpus.shape[0], k):
        if metric == "cosine":
            queries = normalize(queries)
            corpus = corpus if unit_corpus else normalize(corpus)
        d, idx = ops.l2_topk(queries, corpus, kk, mode=metric, mask=mask)
        return d, _empty_slots(d, (idx + base_index).to(torch.int32),
                               chunk, corpus.shape[0])
    pair = get_metric(metric)
    unit = metric == "cosine" and unit_corpus
    if unit:
        queries = normalize(queries)

    def dist(lo: int, hi: int) -> torch.Tensor:
        if unit:
            # pairwise_cosine on rows normalized once: the same bits, since
            # normalize works row by row
            return 1.0 + pairwise_dot(queries, corpus[lo:hi])
        return pair(queries, corpus[lo:hi])

    d, idx = scan_topk(dist, corpus.shape[0], k, chunk=chunk, mask=mask,
                       base_index=base_index)
    return d, _empty_slots(d, idx, chunk, corpus.shape[0])


def _empty_slots(d: torch.Tensor, idx: torch.Tensor, chunk: Optional[int],
                 n: int) -> torch.Tensor:
    """The reference's chunked scan starts from k (+inf, -1) slots and keeps
    them ahead of later +inf candidates, so its +inf slots hold -1; its
    unchunked scan (chunk None or >= n) returns the masked rows' ids."""
    if chunk is None or chunk >= n:
        return idx
    return torch.where(d == float("inf"), torch.full_like(idx, -1), idx)


@dataclass
class FlatIndex:
    """Thin stateful wrapper; all compute is in flat_search."""

    metric: str = "cosine"
    chunk: Optional[int] = None

    def search(self, corpus: torch.Tensor, queries: torch.Tensor, k: int,
               mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return flat_search(queries, corpus, k, metric=self.metric,
                           chunk=self.chunk, mask=mask)
