"""B5, the exact scan's kernel: the wrappers of ``csrc/l2_distance.cu``,
which replaces the JAX package's Pallas ``l2_distance_kernel``
(``src/repro/kernels/l2.py:62``).

Two entries share one main loop (the cross term in 3xTF32 on the tensor
cores, from TMA-fed shared memory where D % 4 == 0 and the rows are
16-byte aligned, from plain loads into the same layout otherwise) and one
epilogue arithmetic:

- `l2_distance` writes the (Q, N) matrix.  At the flat route's shape
  (Q = 1,024 x 65,536 x 128) it is bound by operations: 3 x 1.7e10
  tensor-core flops, 0.104 ms at 495 TFLOP/s TF32.
- `l2_topk` never writes it: each block keeps its query rows' k smallest
  64-bit keys (``topk_smallest``'s key) over a contiguous range of corpus
  tiles, and the ranges' candidates are merged here.  Bound by the same
  operations, with the (Q, N) write and the top-k passes gone.  Its
  distances are the matrix entry's, bit for bit.

Blocks of 128 query rows (Q > 32) or of all Q <= 32 queries (the roles of
queries and corpus swap) times ``splits`` corpus ranges: about one block
per SM.  ``launches`` and ``topk_launches`` count each entry's launches in
this process; each is bumped at its launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build, _launch

launches = 0
topk_launches = 0

_MODES = {"l2": 0, "dot": 1}
_TOPK_MODES = {"l2": 0, "dot": 1, "cosine": 2}
#: the largest k the fused entry takes (flat_search's own limit is lower)
MAX_K = 256
_SWAP_Q = 32          # Q at or under which the kernel swaps roles
_TILE = 128           # query rows a block (Q > 32); corpus rows a tile


@functools.cache
def _fns():
    lib = _build.load("l2_distance")
    return (_launch.c_fn(lib, "l2_distance_f32", n_ptrs=3, n_ints=5),
            _launch.c_fn(lib, "l2_topk_f32", n_ptrs=4, n_ints=6))


def fast_k(nq: int) -> int:
    """The largest k whose top-k lists the fused entry keeps in shared
    memory at ``nq`` queries (past it they live in global memory, slower):
    the kernel's own limit, read from the library."""
    fn = _build.load("l2_distance").l2_topk_fast_k
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return int(fn(nq))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits(nq: int, n: int, device: torch.device) -> int:
    """Corpus ranges a query tile is cut into: enough blocks for about one
    per SM, at least one 128-row tile a range."""
    q_tiles = 1 if nq <= _SWAP_Q else -(-nq // _TILE)
    n_tiles = -(-n // _TILE)
    return max(1, min(n_tiles, _sm_count(device.index) // q_tiles))


def _check(name: str, q: torch.Tensor, x: torch.Tensor) -> None:
    _launch.check_tensors(name, q=q, x=x)
    _launch.check_dtypes(name, q=(q, torch.float32), x=(x, torch.float32))
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1] \
            or q.shape[1] == 0:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, x "
                         f"{tuple(x.shape)}")


def l2_distance(q: torch.Tensor, x: torch.Tensor, *,
                mode: str = "l2") -> torch.Tensor:
    """q (Q, D) × x (N, D) float32 -> (Q, N) float32 on the card:
    ‖q‖² + ‖x‖² − 2·q·x clamped at 0 (``"l2"``) or −q·x (``"dot"``), the
    cross term in 3xTF32, the norms and the sums in fp32."""
    global launches
    name = "l2_distance"
    if mode not in _MODES:
        raise ValueError(f"{name}: mode {mode!r}; have {sorted(_MODES)}")
    _check(name, q, x)
    (nq, d), n = q.shape, x.shape[0]
    out = torch.empty((nq, n), dtype=torch.float32, device=q.device)
    if nq == 0 or n == 0:
        return out
    _launch.launch(name, _fns()[0], q.device, q.data_ptr(), x.data_ptr(),
                   out.data_ptr(), nq, n, d, _MODES[mode],
                   splits(nq, n, q.device))
    with _launch.count_lock:
        launches += 1
    return out


def decode_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 keys (order-preserving float bits << 32 | column) -> (float32
    values, int64 columns): the inverse of ``topk_smallest``'s key."""
    hi = (keys >> 32).to(torch.int32)
    bits = torch.where(hi >= 0, hi, hi ^ 0x7FFFFFFF)
    return bits.view(torch.float32), keys & 0xFFFFFFFF


def l2_topk(q: torch.Tensor, x: torch.Tensor, k: int, *, mode: str = "l2",
            mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row of the distance matrix ``l2_distance``
    (or, for ``"cosine"``, ``1.0 + `` its dot mode) would give, columns
    where ``mask`` (N,) bool is False scoring +inf, without the matrix:
    (distances (Q, k) float32 ascending, columns (Q, k) int64), ties to the
    lowest column — ``topk_smallest`` over that matrix, bit for bit."""
    global topk_launches
    name = "l2_topk"
    if mode not in _TOPK_MODES:
        raise ValueError(f"{name}: mode {mode!r}; have {sorted(_TOPK_MODES)}")
    _check(name, q, x)
    (nq, d), n = q.shape, x.shape[0]
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"{name}: k = {k} outside [1, min({MAX_K}, N = {n})]")
    mask_ptr = None
    if mask is not None:
        _launch.check_tensors(name, mask=mask)
        _launch.check_dtypes(name, mask=(mask, torch.bool))
        if tuple(mask.shape) != (n,):
            raise ValueError(f"{name}: mask shape {tuple(mask.shape)}, "
                             f"want ({n},)")
        mask_ptr = mask.data_ptr()
    if nq == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=q.device),
                torch.empty((0, k), dtype=torch.int64, device=q.device))
    s = splits(nq, n, q.device)
    cand = torch.empty((nq, s, k), dtype=torch.int64, device=q.device)
    _launch.launch(name, _fns()[1], q.device, q.data_ptr(), x.data_ptr(),
                   mask_ptr, cand.data_ptr(), nq, n, d, _TOPK_MODES[mode], k,
                   s)
    with _launch.count_lock:
        topk_launches += 1
    keys = cand.view(nq, s * k)
    if s > 1:
        # the splits' lists are in column order: one more selection on
        # the same unique keys gives the whole scan's k smallest
        keys = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
    return decode_keys(keys)
