"""Fused gather-distance for wide-beam HNSW traversal: the CUDA kernel's
wrappers (``csrc/beam_gather.cu``, replacing the JAX package's Pallas
``beam_gather_kernel``).

Four entries: `beam_gather`, the TPU kernel's function over a (Q, L)
block of ids; `beam_gather_lists`, its l2 mode where the IVF index runs it,
list-major: the probe's (query, rank) entries grouped by list
(`list_tiles`), one block a list and a tile of its queries, each probed
list's rows read once a tile, the (Q, P * M) distances written;
`beam_gather_lists_topk`, the same blocks keeping each (query, list)'s k
smallest ``topk_smallest`` keys instead, merged here: the IVF search's
candidates and their top-k without the matrix; and B1ˢ, `BeamGatherStep`,
the HNSW search's whole layer-0 step (pop, visited test-and-set, B1's
distance on the fresh slots, the ef merge) in one launch, whose plain
version is `beam_gather_step_ref` (`PlainStep`).  ``launches``,
``lists_launches``, ``topk_launches`` and ``step_launches`` count each
entry's launches in this process; each is bumped at its launch and nowhere
else, so a run can show it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .. import tracing
from . import _build, _launch
from .l2 import decode_keys
from .ref import PAD, topk_smallest

MODES = {"l2": 0, "dot": 1}
#: the list-major entry writes its (Q, P * M) output at int32 offsets
MAX_LIST_SLOTS = 2 ** 31 - 1

#: the largest k the fused entry takes (a warp keeps 32 x 4 keys a query);
#: core/ivf.py sends it k up to core/flat.py's FUSED_MAX_K
MAX_TOPK = 128

INF = float("inf")

launches = 0
lists_launches = 0
topk_launches = 0
step_launches = 0


@functools.cache
def _fn():
    return _launch.c_fn(_build.load("beam_gather"), "beam_gather_f32",
                        n_ptrs=4, n_ints=5)


@functools.cache
def _lists_fn():
    return _launch.c_fn(_build.load("beam_gather"), "beam_gather_lists_f32",
                        n_ptrs=8, n_ints=6)


@functools.cache
def _topk_fn():
    return _launch.c_fn(_build.load("beam_gather"),
                        "beam_gather_lists_topk_f32", n_ptrs=9, n_ints=7)


@functools.cache
def tile_q(d: int) -> int:
    """Queries of one list a block of the list-major entry takes at width
    ``d`` (32, or 8 where the wide tile's ring does not fit in shared
    memory): the kernel's own choice."""
    fn = _build.load("beam_gather").beam_gather_lists_tile_q
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return int(fn(d))


def list_tiles(probe: torch.Tensor, nlist: int, tq: int,
               order: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The list-major entries' schedule, on the probe's device with no host
    sync: (entries, starts, tile_end), int32.  ``entries`` are the flat
    (query, rank) entries q * P + j of probe (Q, P), sorted stably by list;
    list l's entries are entries[starts[l]: starts[l + 1]], cut into
    ceil(count / tq) tiles, and tile_end is the inclusive prefix sum of
    those tile counts, the lists taken in ``order`` (a permutation of the
    lists; None: by id).  Probe ids must lie in [0, nlist)."""
    keys, entries = torch.sort(probe.reshape(-1), stable=True)
    bounds = torch.arange(nlist + 1, dtype=keys.dtype, device=keys.device)
    starts = torch.searchsorted(keys, bounds, out_int32=True)
    tiles = (starts[1:] - starts[:-1] + tq - 1) // tq
    if order is not None:
        tiles = tiles[order.long()]
    return (entries.to(torch.int32), starts,
            torch.cumsum(tiles, 0, dtype=torch.int32))


def longest_first(list_len: torch.Tensor) -> torch.Tensor:
    """The fused entry's list order: longest live length first (ties by
    id), so that the grid's last blocks are its shortest."""
    return torch.argsort(list_len, descending=True, stable=True) \
        .to(torch.int32)


def list_blocks(n_entries: int, nlist: int, tq: int) -> int:
    """The list-major entry's grid: an upper bound on the tiles of any
    probe with ``n_entries`` entries over ``nlist`` lists."""
    return -(-n_entries // tq) + nlist


def tile_of_block(starts: torch.Tensor, tile_end: torch.Tensor, tq: int,
                  n_blocks: int, order: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What each block of the grid takes, as the kernels find it (the first
    place in ``order`` whose tile_end exceeds the block's index, and the
    list there): (list, first entry, entry count) a block, int64, list =
    nlist and count 0 past the last tile."""
    nlist = tile_end.shape[0]
    blk = torch.arange(n_blocks, device=tile_end.device)
    pos = torch.searchsorted(tile_end.long(), blk, right=True)
    live = pos < nlist
    safe = pos.clamp_max(nlist - 1)
    lst = safe if order is None else order.long()[safe]
    first, count = starts[lst].long(), (starts[lst + 1] - starts[lst]).long()
    t = blk - (tile_end[safe].long() - (count + tq - 1) // tq)
    n = torch.minimum(torch.full_like(count, tq), count - t * tq)
    return torch.where(live, lst, nlist), first + t * tq, \
        torch.where(live, n, 0)


def _check_lists(name, q, probe, lists, list_len, corpus):
    """The list-major entries' checks; returns ((Q, D), P, (nlist, M))."""
    _launch.check_tensors(name, q=q, probe=probe, lists=lists,
                          list_len=list_len, corpus=corpus)
    _launch.check_dtypes(name, q=(q, torch.float32),
                         probe=(probe, torch.int32),
                         lists=(lists, torch.int32),
                         list_len=(list_len, torch.int32),
                         corpus=(corpus, torch.float32))
    if q.dim() != 2 or probe.dim() != 2 or lists.dim() != 2 \
            or corpus.dim() != 2 or probe.shape[0] != q.shape[0] \
            or q.shape[1] != corpus.shape[1] \
            or tuple(list_len.shape) != (lists.shape[0],):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, probe "
                         f"{tuple(probe.shape)}, lists {tuple(lists.shape)}, "
                         f"list_len {tuple(list_len.shape)}, corpus "
                         f"{tuple(corpus.shape)}")
    return q.shape, probe.shape[1], lists.shape


def beam_gather(q: torch.Tensor, ids: torch.Tensor, corpus: torch.Tensor, *,
                mode: str = "l2") -> torch.Tensor:
    """q (Q, D) f32 × ids (Q, L) i32 × corpus (N, D) f32 -> (Q, L) f32, on
    the card: squared L2 (diff-square-sum) or negated inner product of each
    query against its gathered rows.  ids must lie in [0, N)."""
    global launches
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}")
    _launch.check_tensors("beam_gather", q=q, ids=ids, corpus=corpus)
    _launch.check_dtypes("beam_gather", q=(q, torch.float32),
                         ids=(ids, torch.int32),
                         corpus=(corpus, torch.float32))
    if q.dim() != 2 or ids.dim() != 2 or corpus.dim() != 2 \
            or ids.shape[0] != q.shape[0] or q.shape[1] != corpus.shape[1]:
        raise ValueError(f"beam_gather: shapes q {tuple(q.shape)}, ids "
                         f"{tuple(ids.shape)}, corpus {tuple(corpus.shape)}")
    (nq, d), l, n = q.shape, ids.shape[1], corpus.shape[0]
    out = torch.empty((nq, l), dtype=torch.float32, device=corpus.device)
    if nq == 0 or l == 0:
        return out
    _launch.launch("beam_gather", _fn(), corpus.device, q.data_ptr(),
                   ids.data_ptr(), corpus.data_ptr(), out.data_ptr(), nq, l,
                   d, n, MODES[mode])
    with _launch.count_lock:
        launches += 1
    return out


def beam_gather_lists(q: torch.Tensor, probe: torch.Tensor,
                      lists: torch.Tensor, list_len: torch.Tensor,
                      corpus: torch.Tensor) -> torch.Tensor:
    """q (Q, D) f32 × probe (Q, P) i32 list ids × lists (nlist, M) i32 (PAD
    -1) × list_len (nlist,) i32 × corpus (N, D) f32 -> (Q, P * M) f32 on the
    card: out[q, j * M + r] is `beam_gather`'s l2 value (bit for bit) of q
    and corpus[lists[probe[q, j], r]], +inf where r >= list_len[probe[q,
    j]] or the slot is PAD.  Probe ids must lie in [0, nlist), other ids
    in [0, N)."""
    global lists_launches
    name = "beam_gather_lists"
    (nq, d), p, (nlist, m) = _check_lists(name, q, probe, lists, list_len,
                                          corpus)
    if nq * p * m > MAX_LIST_SLOTS:
        raise ValueError(f"{name}: {nq} x {p} x {m} output slots exceed the "
                         f"kernel's int32 offsets ({MAX_LIST_SLOTS})")
    out = torch.empty((nq, p * m), dtype=torch.float32, device=q.device)
    if nq == 0 or p == 0 or m == 0:
        return out
    tq = tile_q(d)
    entries, starts, tile_end = list_tiles(probe, nlist, tq)
    _launch.launch(name, _lists_fn(), q.device, q.data_ptr(),
                   entries.data_ptr(), starts.data_ptr(), tile_end.data_ptr(),
                   lists.data_ptr(), list_len.data_ptr(), corpus.data_ptr(),
                   out.data_ptr(), nq, p, m, d, corpus.shape[0], nlist)
    with _launch.count_lock:
        lists_launches += 1
    return out


def beam_gather_lists_topk(q: torch.Tensor, probe: torch.Tensor,
                           lists: torch.Tensor, list_len: torch.Tensor,
                           corpus: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`beam_gather_lists`'s inputs and k -> (distances (Q, kk) float32
    ascending, columns (Q, kk) int64 of the (Q, P * M) matrix that entry
    writes), kk = min(k, P * M), on the card without that matrix:
    ``topk_smallest`` of it bit for bit, every distance and the column of
    every finite one (a +inf one may name another +inf slot).  Each block
    keeps its (query, list) pairs' min(k, M) smallest keys in (Q, P,
    min(k, M)); one selection here merges a query's P lists, as
    ``l2_topk`` merges its splits.  The lists' tiles run `longest_first`,
    so the grid's tail is its shortest blocks; the order changes no result.
    Refused, before the tensors are checked: k < 1, or min(k, M) past
    MAX_TOPK (the kernel's lists)."""
    global topk_launches
    name = "beam_gather_lists_topk"
    m = lists.shape[-1]
    kl = min(k, m)
    if not 1 <= kl <= MAX_TOPK:
        raise ValueError(f"{name}: k = {k} at max_list {m} keeps {kl} keys "
                         f"a list, outside [1, {MAX_TOPK}]")
    (nq, d), p, (nlist, m) = _check_lists(name, q, probe, lists, list_len,
                                          corpus)
    if nq * p > MAX_LIST_SLOTS or p * m > MAX_LIST_SLOTS:
        raise ValueError(f"{name}: {nq} x {p} entries or {p} x {m} columns "
                         f"exceed the kernel's int32 offsets")
    kk = min(k, p * m)
    if nq == 0 or p == 0:
        return (torch.empty((nq, kk), dtype=torch.float32, device=q.device),
                torch.empty((nq, kk), dtype=torch.int64, device=q.device))
    order = longest_first(list_len)
    entries, starts, tile_end = list_tiles(probe, nlist, tile_q(d), order)
    cand = torch.empty((nq, p, kl), dtype=torch.int64, device=q.device)
    _launch.launch(name, _topk_fn(), q.device, q.data_ptr(),
                   entries.data_ptr(), starts.data_ptr(), tile_end.data_ptr(),
                   order.data_ptr(), lists.data_ptr(), list_len.data_ptr(),
                   corpus.data_ptr(), cand.data_ptr(), nq, p, m, d,
                   corpus.shape[0], nlist, k)
    with _launch.count_lock:
        topk_launches += 1
    # each list's keys are unique and hold its kl smallest: the query's kk
    # smallest lie among them
    keys = torch.topk(cand.view(nq, p * kl), kk, dim=1, largest=False,
                      sorted=True).values
    return decode_keys(keys)


# ---------------------------------------------------------------- B1ˢ

class BeamState(NamedTuple):
    """One search's layer-0 state, which either step updates: the plain one
    into new tensors, B1ˢ in place."""

    cand_d: torch.Tensor      # (Q, ef) float32, ascending by topk_smallest
    cand_id: torch.Tensor     # (Q, ef) int64, -1 = empty
    expanded: torch.Tensor    # (Q, ef) bool
    visited: torch.Tensor     # (Q, ceil(N / 32)) int64 words, 32 bits each
    iters: torch.Tensor       # (Q,) int32 steps taken
    active: torch.Tensor      # (Q,) bool: still searching


def beam_gather_step_ref(state: BeamState, adj0: torch.Tensor, width: int,
                         max_iters: int, block_dist: Callable,
                         count: bool = False
                         ) -> Tuple[BeamState, Optional[torch.Tensor]]:
    """B1ˢ's plain version: one layer-0 step of every active query as
    PyTorch ops, under the spans ``hnsw.pop``, ``hnsw.visit``,
    ``hnsw.distance`` and ``hnsw.merge``.  ``block_dist(ids, fresh)`` maps
    int64 ids (Q, L) (PAD allowed) and a bool mask (Q, L) to float32
    distances, +inf where the mask is False.  Returns (the new state, the
    step's fresh slots summed on the device where ``count``, else None)."""
    cand_d, cand_id, expanded, visited, iters, active = state
    nq, ef = cand_d.shape
    length = width * adj0.shape[1]
    act = active[:, None]
    with tracing.span("hnsw.pop"):
        # pop the top-B nearest unexpanded candidates of each active query
        pop_d, sel = topk_smallest(torch.where(expanded, INF, cand_d), width)
        pop_ok = torch.isfinite(pop_d) & act
        # surplus sel slots (pop_ok False) are INF: empty or already
        # expanded, so marking them is moot — as in the JAX package
        expanded = torch.where(act, expanded.scatter(1, sel, True), expanded)
        nodes = torch.where(pop_ok, cand_id.gather(1, sel), PAD)

    with tracing.span("hnsw.visit"):
        adj_rows = adj0[nodes.clamp_min(0)].long()           # (Q, B, M0)
        adj_rows = torch.where(pop_ok[:, :, None], adj_rows, PAD)
        # visited OR-update, one popped row after the other: each row's
        # bits land before the next row's membership test, so a neighbour
        # shared by several popped candidates is fresh exactly once.  Rows
        # are duplicate-free (graph invariant) and the bits added were
        # clear, so add == or.
        fresh_rows = []
        for b in range(width):
            nbrs_b = adj_rows[:, b]
            safe_b = nbrs_b.clamp_min(0)
            word_b = safe_b // 32
            bit_b = safe_b % 32
            seen_b = (visited.gather(1, word_b) >> bit_b) & 1
            fresh_b = (nbrs_b != PAD) & (seen_b == 0)
            visited.scatter_add_(1, word_b,
                                 torch.where(fresh_b, 1 << bit_b, 0))
            fresh_rows.append(fresh_b)
        nbrs = adj_rows.reshape(nq, length)
        fresh = torch.stack(fresh_rows, 1).reshape(nq, length)

    with tracing.span("hnsw.distance"):
        d = block_dist(nbrs, fresh)                          # fused
    fresh_sum = fresh.sum() if count else None

    with tracing.span("hnsw.merge"):
        new_id = torch.where(fresh, nbrs, -1)
        merged_d = torch.cat([cand_d, d], 1)
        merged_id = torch.cat([cand_id, new_id], 1)
        # stale: never expand
        merged_exp = torch.cat([expanded, ~fresh], 1)
        top_d, keep = topk_smallest(merged_d, ef)
        cand_d = torch.where(act, top_d, cand_d)
        cand_id = torch.where(act, merged_id.gather(1, keep), cand_id)
        expanded = torch.where(act, merged_exp.gather(1, keep), expanded)
        iters += active.to(torch.int32)
        active = (~expanded & torch.isfinite(cand_d)).any(1) \
            & (iters < max_iters)
    return BeamState(cand_d, cand_id, expanded, visited, iters,
                     active), fresh_sum


class PlainStep:
    """The layer-0 loop's step as `beam_gather_step_ref`: on the CPU, under
    ``force_ref``, and in the code-domain modes (whose ``block_dist`` is
    B3's or B4's).  The loop's interface, as
    `BeamGatherStep`'s: call it for a step, then `n_active` (a sync) and,
    where the steps counted, `fresh`."""

    def __init__(self, state: BeamState, adj0: torch.Tensor, width: int,
                 max_iters: int, block_dist: Callable):
        self.state = state
        self._adj0, self._width, self._max_iters = adj0, width, max_iters
        self._block_dist = block_dist
        self._fresh = None

    def __call__(self, count: bool = False) -> None:
        self.state, fresh = beam_gather_step_ref(
            self.state, self._adj0, self._width, self._max_iters,
            self._block_dist, count)
        if fresh is not None:
            self._fresh = fresh if self._fresh is None \
                else self._fresh.add_(fresh)

    def n_active(self) -> int:
        """The queries still active: one read of a device value."""
        return int(self.state.active.sum())

    def fresh(self) -> Optional[int]:
        """The fresh slots of the counted steps; None if none counted."""
        return None if self._fresh is None else int(self._fresh)


@functools.cache
def _step_fn():
    return _launch.c_fn(_build.load("beam_gather"), "beam_gather_step_f32",
                        n_ptrs=12, n_ints=10)


@functools.cache
def _step_lib():
    """The step entry's helpers, typed: (work(ef, width, M0, D): the
    workspace a query in bytes, 0 where the step's plan fits in shared
    memory; host_ptr; wait)."""
    lib = _build.load("beam_gather")
    work = lib.beam_gather_step_work
    work.argtypes = [ctypes.c_int] * 4
    work.restype = ctypes.c_longlong
    host_ptr = lib.beam_gather_step_host_ptr
    host_ptr.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    host_ptr.restype = ctypes.c_int
    wait = lib.beam_gather_step_wait
    wait.argtypes, wait.restype = [ctypes.c_void_p], ctypes.c_int
    return work, host_ptr, wait


class BeamGatherStep:
    """B1ˢ for one search's layer-0 loop: the checks run, the pointers and
    the stream are resolved and the counters are allocated once, here; each
    call is one launch and nothing else.

    q (Q, D) f32 × adj0 (N_adj, M0) i32 (PAD -1) × corpus (N, D) f32 and
    the search's `BeamState` (contiguous, on the card; each buffer sorted
    by topk_smallest's key, as `beam_state` and every step leave it), mode
    "l2" | "dot", 1 <= width <= ef: each call advances every active query
    one step in place, bit for bit `beam_gather_step_ref` with B1 as its
    distance, at any ef, width · M0 and D (a plan past shared memory gets
    a workspace on the card, allocated here).  `n_active` waits for the
    step and reads the active queries from a pinned host buffer the kernel
    writes; `fresh` reads the search's fresh slots from it."""

    def __init__(self, q: torch.Tensor, adj0: torch.Tensor,
                 corpus: torch.Tensor, state: BeamState, *, width: int,
                 max_iters: int, mode: str):
        name = "beam_gather_step"
        if mode not in MODES:
            raise ValueError(f"{name}: mode {mode!r}")
        _launch.check_tensors(name, q=q, adj0=adj0, corpus=corpus,
                              **state._asdict())
        _launch.check_dtypes(
            name, q=(q, torch.float32), adj0=(adj0, torch.int32),
            corpus=(corpus, torch.float32),
            cand_d=(state.cand_d, torch.float32),
            cand_id=(state.cand_id, torch.int64),
            expanded=(state.expanded, torch.bool),
            visited=(state.visited, torch.int64),
            iters=(state.iters, torch.int32),
            active=(state.active, torch.bool))
        if q.dim() != 2 or adj0.dim() != 2 or corpus.dim() != 2 \
                or state.cand_d.dim() != 2:
            raise ValueError(f"{name}: shapes q {tuple(q.shape)}, adj0 "
                             f"{tuple(adj0.shape)}, corpus "
                             f"{tuple(corpus.shape)}, cand_d "
                             f"{tuple(state.cand_d.shape)}")
        (nq, d), (n, m0) = q.shape, adj0.shape
        ef = state.cand_d.shape[1]
        n_words = (corpus.shape[0] + 31) // 32
        if corpus.shape[1] != d \
                or state.cand_d.shape != (nq, ef) \
                or state.cand_id.shape != (nq, ef) \
                or state.expanded.shape != (nq, ef) \
                or state.visited.shape != (nq, n_words) \
                or state.iters.shape != (nq,) or state.active.shape != (nq,):
            raise ValueError(
                f"{name}: shapes q {tuple(q.shape)}, adj0 "
                f"{tuple(adj0.shape)}, corpus {tuple(corpus.shape)}, "
                + ", ".join(f"{k} {tuple(v.shape)}"
                            for k, v in state._asdict().items()))
        if not 1 <= width <= ef:
            raise ValueError(f"{name}: width {width} outside [1, ef {ef}]")
        dev = corpus.device
        self.state = state
        self._inputs = (q, adj0, corpus)   # the kernel reads them by pointer
        self._counts = torch.zeros(4, dtype=torch.int64, device=dev)
        self._host = torch.zeros(2, dtype=torch.int64, pin_memory=True)
        self._host_np = self._host.numpy()
        work_fn, host_ptr, self._wait = _step_lib()
        self._work = torch.empty(nq * work_fn(ef, width, m0, d),
                                 dtype=torch.uint8, device=dev)
        dev_ptr = ctypes.c_void_p()
        err = host_ptr(self._host.data_ptr(), ctypes.byref(dev_ptr))
        if err:
            raise RuntimeError(f"{name}: the pinned counts buffer is not "
                               f"mapped: CUDA error {err}")
        self._index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        self._stream = torch._C._cuda_getCurrentRawStream(self._index)
        self._fn = _step_fn()
        self._args = (q.data_ptr(), adj0.data_ptr(), corpus.data_ptr(),
                      *(t.data_ptr() for t in state), self._counts.data_ptr(),
                      dev_ptr.value, self._work.data_ptr() or None,
                      nq, ef, m0, width, d, corpus.shape[0],
                      n, n_words, max_iters, MODES[mode], self._stream)
        # every active query takes a step a launch and stops at max_iters:
        # a loop past that has misread its counts
        self._left = max_iters if nq else 0

    def _call(self, fn, *args) -> int:
        if torch.cuda.current_device() == self._index:
            return fn(*args)
        with torch.cuda.device(self._index):
            return fn(*args)

    def __call__(self, count: bool = False) -> None:
        """One step of every active query (the counts are always kept)."""
        global step_launches
        if self._left <= 0:
            raise RuntimeError("beam_gather_step: a step past max_iters")
        err = self._call(self._fn, *self._args)
        if err:
            raise RuntimeError(f"beam_gather_step launch failed: CUDA error "
                               f"{err}")
        self._left -= 1
        with _launch.count_lock:
            step_launches += 1

    def n_active(self) -> int:
        """Wait for the step; the queries still active after it."""
        err = self._call(self._wait, self._stream)
        if err:
            raise RuntimeError(f"beam_gather_step: CUDA error {err}")
        return int(self._host_np[0])

    def fresh(self) -> int:
        """The search's fresh slots so far (read after `n_active`)."""
        return int(self._host_np[1])
