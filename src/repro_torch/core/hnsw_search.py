"""HNSW search in PyTorch, batched over queries in lockstep.

The port of the JAX package's ``repro.core.hnsw_search``.  There, one query
is written as fixed-shape loops (``lax.while_loop``) and ``vmap`` runs the
batch: each query's state freezes once its own loop condition fails, while
the batch steps until the slowest query is done.  Here the batch is written
out: every loop runs while any query is active, and each query's state
update — candidate buffer, expanded flags, visited bits, iteration counter —
is masked with that query's own condition, so per-query results and
iteration counts are the JAX package's.

  greedy upper-layer descent   -> lockstep move-to-nearest over the gathered
                                  (Q, M) neighbour rows
  candidate buffer             -> (Q, ef) rows merged with `topk_smallest`
                                  (lowest index first on ties, as lax.top_k)
  visited set                  -> (Q, ceil(N/32)) int64 words holding 32
                                  bits each (no unsigned shifts, which torch
                                  lacks on the CPU), OR-updated by
                                  ``scatter_add_`` one popped row after the
                                  other (exact: the bits added are distinct
                                  and were clear)
  layer-0 step                 -> on a card, in the float modes (l2 /
                                  dot), one launch of B1ˢ a step
                                  (``beam_gather_step``: pop, visited
                                  test-and-set, B1's distance on the fresh
                                  slots and the ef merge in one kernel),
                                  at every shape; else the plain step
                                  (``kernels/beam_gather.py``
                                  ``PlainStep``): the ops above and one
                                  fused (Q, B·M0) gather-distance call per
                                  iteration (kernels/ops.py: the
                                  ``beam_gather`` CUDA kernel on a card,
                                  or in code domain ``beam_gather_adc`` /
                                  ``beam_gather_hamming_masked`` over the
                                  PQ codes / packed BQ words in
                                  ``HNSWGraph.codes``); stale and PAD slots
                                  are +inf (the Hamming entry masks them
                                  itself and reads no row for them)

The code-domain modes descend the upper layers on the float proxy vectors
(PQ reconstructions under l2, BQ ±1 signs under dot) and evaluate every
layer-0 distance on the codes, as in the JAX package.

Spans (`repro_torch.tracing`, recorded while a profiler runs):
``hnsw.descent`` (count ``iters``: upper-layer iterations) around the upper
layers; ``hnsw.step`` for each layer-0 iteration (counts ``queries`` Q,
``active``: queries still searching, ``slots``: the (Q, width·M0) slots of
the step's block, and ``fresh``: the batch's fresh slots, read once at the
loop's last sync and counted on the last step), holding B1ˢ's launch or
the plain step's ``hnsw.pop``, ``hnsw.visit``, ``hnsw.distance`` (B1) and
``hnsw.merge``, and ``hnsw.wait``, the step's one sync, which reads the
next step's active count.  Every sync is an ``hnsw.wait``: the descent's,
the step's, and the one before the first step.  So each step launches B1ˢ
or B1 once, and the entry points' B1 launch lies outside every step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from ..kernels import ops
from ..kernels.beam_gather import BeamState, PlainStep
from ..kernels.ref import gathered_dists
from .hnsw_build import PAD, PackedHNSW, make_dist_fn, preprocess_vectors

INF = float("inf")

DEFAULT_EXPANSION_WIDTH = 4


class HNSWGraph(NamedTuple):
    """Device-resident packed graph."""

    vectors: torch.Tensor     # (N, D) float32, metric-preprocessed
    adj0: torch.Tensor        # (N, M0) int32, PAD = -1
    upper_ids: torch.Tensor   # (U,) int64 upper-slot -> global id
    upper_adj: torch.Tensor   # (U, L_top, M) int64 upper-slot ids, PAD = -1
    entry_global: int
    entry_upper: int
    # (N, m) uint8 | int32 PQ codes or (N, W) int32 packed BQ words
    codes: Optional[torch.Tensor] = None


def to_device(packed: PackedHNSW, device="cuda",
              codes: Optional[np.ndarray] = None
              ) -> Tuple[HNSWGraph, int, str]:
    """Returns (graph tensors on ``device``, max_level, search metric).

    ``codes`` optionally ships the quantized corpus (PQ codes or packed BQ
    words, the port's dtypes) beside the float proxy vectors, for the
    code-domain modes ("adc" / "hamming") of :func:`search`.
    """
    dev = resolve_device(device)
    g = HNSWGraph(
        vectors=torch.as_tensor(np.asarray(packed.vectors, np.float32)).to(dev),
        adj0=torch.as_tensor(np.asarray(packed.adj0, np.int32)).to(dev),
        upper_ids=torch.as_tensor(np.asarray(packed.upper_ids, np.int64)).to(dev),
        upper_adj=torch.as_tensor(np.asarray(packed.upper_adj, np.int64)).to(dev),
        entry_global=int(packed.entry_global),
        entry_upper=int(packed.entry_upper),
        codes=None if codes is None else torch.as_tensor(codes).to(dev),
    )
    metric = "l2" if packed.config.metric == "l2" else "dot"
    return g, int(packed.max_level), metric


def _descend(q: torch.Tensor, g: HNSWGraph, layer: int, cur: torch.Tensor,
             metric: str) -> Tuple[torch.Tensor, int]:
    """Greedy move-to-nearest at one upper layer; cur (Q,) upper slots.
    Returns (the slots it ends on, the loop's iterations)."""
    d_cur = gathered_dists(q, g.vectors[g.upper_ids[cur]][:, None, :],
                           metric)[:, 0]
    moved = torch.ones_like(cur, dtype=torch.bool)
    iters = 0
    while True:
        with tracing.span("hnsw.wait", wait=True):
            if not bool(moved.any()):
                return cur, iters
        iters += 1
        nbrs = g.upper_adj[cur, layer]                  # (Q, M) upper slots
        valid = nbrs != PAD
        rows = g.vectors[g.upper_ids[nbrs.clamp_min(0)]]   # (Q, M, D)
        d = torch.where(valid, gathered_dists(q, rows, metric), INF)
        j = d.argmin(1, keepdim=True)
        dj = d.gather(1, j)[:, 0]
        moved = moved & (dj < d_cur)                    # frozen stay frozen
        cur = torch.where(moved, nbrs.gather(1, j)[:, 0], cur)
        d_cur = torch.where(moved, dj, d_cur)


def beam_state(ep: torch.Tensor, ef: int, max_iters: int, n_words: int,
               block_dist) -> BeamState:
    """The layer-0 loop's state before its first step, from the entry
    points ep (Q,): each query's buffer holds its entry point alone, whose
    visited bit is set; ``block_dist`` as `_beam_search_base`'s."""
    nq = ep.shape[0]
    dev = ep.device
    cand_d = torch.full((nq, ef), INF, device=dev)
    cand_d[:, 0] = block_dist(
        ep[:, None], torch.ones((nq, 1), dtype=torch.bool, device=dev))[:, 0]
    cand_id = torch.full((nq, ef), -1, dtype=torch.int64, device=dev)
    cand_id[:, 0] = ep
    expanded = torch.zeros((nq, ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((nq, n_words), dtype=torch.int64, device=dev)
    visited.scatter_(1, (ep // 32)[:, None], (1 << (ep % 32))[:, None])
    iters = torch.zeros((nq,), dtype=torch.int32, device=dev)
    active = (~expanded & torch.isfinite(cand_d)).any(1) & (iters < max_iters)
    return BeamState(cand_d, cand_id, expanded, visited, iters, active)


def _beam_search_base(g: HNSWGraph, ep: torch.Tensor, ef: int, width: int,
                      max_iters: int, n_words: int, block_dist,
                      fused: Optional[Callable] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-ef wide-beam search on layer 0 for the batch of entry points
    ep (Q,).  ``block_dist(ids, fresh)`` maps int64 ids (Q, L) (PAD = -1
    allowed) and a bool mask (Q, L) to float32 distances, +inf where the
    mask is False: the entry points' distances, and the plain step's.
    ``fused(state)``, where given, returns B1ˢ's step for the state, or
    None where the loop takes the plain step.  Returns (dists (Q, ef), ids
    (Q, ef) int64, iterations (Q,))."""
    nq = ep.shape[0]
    length = width * g.adj0.shape[1]
    state = beam_state(ep, ef, max_iters, n_words, block_dist)
    step = fused(state) if fused is not None else None
    if step is None:
        step = PlainStep(state, g.adj0, width, max_iters, block_dist)

    slots = nq * length
    with tracing.span("hnsw.wait", wait=True):
        n_active = int(state.active.sum())
    while n_active:
        with tracing.span("hnsw.step", queries=nq, active=n_active,
                          slots=slots) as sp:
            # the fresh slots are counted while spans record, and read
            # once, at the loop's last sync (counted on the last step)
            step(count=bool(sp))
            with tracing.span("hnsw.wait", wait=True):
                n_active = step.n_active()
                if not n_active and sp:
                    fresh = step.fresh()
                    if fresh is not None:
                        sp.count(fresh=fresh)
    return step.state.cand_d, step.state.cand_id, step.state.iters


def search(g: HNSWGraph, queries: torch.Tensor, *, k: int, ef: int,
           max_level: int, metric: str = "dot",
           expansion_width: int = DEFAULT_EXPANSION_WIDTH,
           max_iters: Optional[int] = None,
           q_codes: Optional[torch.Tensor] = None,
           with_iters: bool = False, force_ref: bool = False):
    """Batched HNSW search.

    Args:
      g: graph from :func:`to_device`; the search runs on its device.
      queries: (Q, D) — pre-normalize for cosine (the graph stores the corpus
        normalized; use metric="dot").  For the code-domain modes this is
        the float proxy the upper-layer descent uses (PQ: the normalized
        query; BQ: its ±1 sign vector).
      k: neighbours to return (k <= ef).
      ef: beam width (result-buffer size).
      max_level: top layer of the graph.
      metric: "dot" | "l2", or the code-domain modes "adc" / "hamming"
        (need ``g.codes`` and ``q_codes``).
      expansion_width: candidates popped (and adjacency rows fused) per
        layer-0 iteration; 1 == classic single-pop traversal.
      max_iters: expansion-iteration budget; default 4*ef.
      q_codes: per-query code-domain payload: (Q, m, k) ADC LUTs for
        "adc", (Q, W) int32 packed query words for "hamming".
      with_iters: additionally return the (Q,) int32 layer-0 loop-trip
        counters.
      force_ref: the float modes' layer-0 loop takes the plain step
        (PyTorch ops; on a card its distances are still B1's) where it
        would take B1ˢ.

    Returns:
      (distances (Q, k) ascending raw scores, ids (Q, k) int32; -1 =
      unfilled) [, iterations (Q,) if with_iters].
    """
    if max_iters is None:
        max_iters = 4 * ef
    if k > ef:
        raise ValueError(f"k={k} > ef={ef}")
    if metric not in ("l2", "dot", "adc", "hamming"):
        raise ValueError(f"metric {metric!r}")
    if metric in ("adc", "hamming") and (g.codes is None or q_codes is None):
        raise ValueError(f"metric {metric!r} needs g.codes and q_codes")
    descent_metric = {"adc": "l2", "hamming": "dot"}.get(metric, metric)
    # a beam can't pop more candidates than the buffer holds (tiny corpora)
    width = max(1, min(int(expansion_width), ef))
    dev = g.vectors.device
    n_words = (g.vectors.shape[0] + 31) // 32
    queries = torch.as_tensor(queries).to(dev, torch.float32).contiguous()
    nq = queries.shape[0]

    slot = torch.full((nq,), g.entry_upper, dtype=torch.int64, device=dev)
    with tracing.span("hnsw.descent") as descent:
        for layer in range(max_level, 0, -1):
            slot, n = _descend(queries, g, layer - 1, slot, descent_metric)
            descent.count(iters=n)
    if max_level > 0:
        ep = g.upper_ids[slot]
    else:
        ep = torch.full((nq,), g.entry_global, dtype=torch.int64, device=dev)

    if metric == "adc":
        def block_dist(ids, fresh):
            return torch.where(fresh, ops.beam_gather_adc(
                q_codes, ids.clamp_min(0), g.codes), INF)
    elif metric == "hamming":
        def block_dist(ids, fresh):
            return ops.beam_gather_hamming_masked(q_codes, ids, fresh,
                                                  g.codes)
    else:
        def block_dist(ids, fresh):
            return torch.where(fresh, ops.beam_gather_distances(
                queries, ids.clamp_min(0), g.vectors, mode=metric), INF)

    fused = None
    if metric in ("l2", "dot"):
        # the float modes' steps: B1ˢ on a card
        def fused(state):
            return ops.beam_gather_step(queries, g.adj0, g.vectors, state,
                                        width=width, max_iters=max_iters,
                                        mode=metric, force_ref=force_ref)

    d, ids, iters = _beam_search_base(g, ep, ef, width, max_iters, n_words,
                                      block_dist, fused)
    d, ids = d[:, :k], ids[:, :k].to(torch.int32)
    return (d, ids, iters) if with_iters else (d, ids)


def search_numpy_reference(packed: PackedHNSW, queries: np.ndarray, k: int,
                           ef: int,
                           expansion_width: int = DEFAULT_EXPANSION_WIDTH,
                           block_sizes: Optional[list] = None,
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Host oracle mirroring the fixed-shape device algorithm (test parity),
    width-aware: pops ``expansion_width`` candidates per iteration, expands
    their neighbour rows as one first-occurrence-deduplicated block, and
    merges with a single stable top-ef selection — the same visit order and
    tie-breaking as the device wide-beam loop.  (numpy copy of the JAX
    package's oracle.)  ``block_sizes``, where given, gets each iteration's
    block length appended: the fresh slots the device loop gathers."""
    metric = packed.config.metric
    vecs = packed.vectors
    dist = make_dist_fn(vecs, metric)
    q_all = preprocess_vectors(queries, metric)
    width = max(1, int(expansion_width))
    out_d = np.full((len(q_all), k), np.inf, dtype=np.float32)
    out_i = np.full((len(q_all), k), -1, dtype=np.int32)

    width = min(width, ef)                     # mirror the device clamp
    for qi, q in enumerate(q_all):
        # descent
        slot = packed.entry_upper
        for layer in range(packed.max_level, 0, -1):
            while True:
                nbrs = packed.upper_adj[slot, layer - 1]
                nbrs = nbrs[nbrs != PAD]
                if len(nbrs) == 0:
                    break
                d_cur = dist(q, np.array([packed.upper_ids[slot]], np.int64))[0]
                ds = dist(q, packed.upper_ids[nbrs].astype(np.int64))
                j = int(np.argmin(ds))
                if ds[j] < d_cur:
                    slot = int(nbrs[j])
                else:
                    break
        ep = int(packed.upper_ids[slot]) if packed.max_level > 0 \
            else packed.entry_global
        # wide beam
        cand_d = np.full((ef,), np.inf, np.float32)
        cand_i = np.full((ef,), -1, np.int64)
        expanded = np.zeros((ef,), bool)
        cand_d[0] = dist(q, np.array([ep], np.int64))[0]
        cand_i[0] = ep
        visited = {ep}
        for _ in range(4 * ef):
            masked = np.where(~expanded, cand_d, np.inf)
            pops = [int(c) for c in np.argsort(masked, kind="stable")[:width]
                    if np.isfinite(masked[c])]
            if not pops:
                break
            block: list = []
            for c in pops:
                expanded[c] = True
                nbrs = packed.adj0[cand_i[c]]
                # sequential visited update == the device block's
                # first-occurrence dedup in flattened row-major order
                fresh = [int(e) for e in nbrs
                         if e != PAD and e not in visited]
                visited.update(fresh)
                block.extend(fresh)
            if block_sizes is not None:
                block_sizes.append(len(block))
            if not block:
                continue
            ds = dist(q, np.asarray(block, np.int64))
            md = np.concatenate([cand_d, ds])
            mi = np.concatenate([cand_i, block])
            me = np.concatenate([expanded, np.zeros(len(block), bool)])
            keep = np.argsort(md, kind="stable")[:ef]
            cand_d, cand_i, expanded = md[keep], mi[keep], me[keep]
        out_d[qi] = cand_d[:k]
        out_i[qi] = cand_i[:k]
    return out_d, out_i


def recall_at_k(found_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Mean fraction of true k-NN recovered (ann-benchmarks style)."""
    found = np.asarray(found_ids)
    true = np.asarray(true_ids)
    k = true.shape[1]
    hits = (true[:, :, None] == found[:, None, :k]).any(axis=2).sum()
    return float(hits) / (true.shape[0] * k)
