"""Fused gather-distance for wide-beam HNSW traversal: the CUDA kernel's
wrappers (``csrc/beam_gather.cu``, replacing the JAX package's Pallas
``beam_gather_kernel``).

Three entries: `beam_gather`, the TPU kernel's function over a (Q, L)
block of ids; `beam_gather_lists`, its l2 mode where the IVF index runs it,
list-major: the probe's (query, rank) entries grouped by list
(`list_tiles`), one block a list and a tile of its queries, each probed
list's rows read once a tile, the (Q, P * M) distances written; and
`beam_gather_lists_topk`, the same blocks keeping each (query, list)'s k
smallest ``topk_smallest`` keys instead, merged here: the IVF search's
candidates and their top-k without the matrix.  ``launches``,
``lists_launches`` and ``topk_launches`` count each entry's launches in
this process; each is bumped at its launch and nowhere else, so a run can
show it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build, _launch
from .l2 import decode_keys

MODES = {"l2": 0, "dot": 1}
#: the list-major entry writes its (Q, P * M) output at int32 offsets
MAX_LIST_SLOTS = 2 ** 31 - 1

#: the largest k the fused entry takes (a warp keeps 32 x 4 keys a query);
#: core/ivf.py sends it k up to core/flat.py's FUSED_MAX_K
MAX_TOPK = 128

launches = 0
lists_launches = 0
topk_launches = 0


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
