"""sLSTM recurrence over a sequence: the CUDA kernel's wrapper
(``csrc/slstm.cu``, replacing the JAX package's Pallas
``slstm_sequence_kernel``).

``launches`` counts the kernel's launches in this process, one per sequence
(each launch walks every timestep), and ``path_launches`` the same launches
by the path the kernel took: ``"cluster"`` (one thread-block cluster per
head and batch-row group, R on chip, h through distributed shared memory;
every head width that is a multiple of 32 up to 512) or ``"l2"`` (the
cooperative launch that reads R from L2 or shared memory and ends each step
with a grid barrier; the other widths).  Both are bumped at the launch and
nowhere else.  ``last_launch`` holds the last launch's layout.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, _launch

launches = 0
path_launches = {"cluster": 0, "l2": 0}
# {"path", "rows_per_cluster", "cluster_size", "active_clusters"}
last_launch: dict = {}

_SYMBOLS = {torch.float32: "slstm_sequence_f32",
            torch.bfloat16: "slstm_sequence_bf16"}


@functools.cache
def _fn(dtype: torch.dtype):
    return _launch.c_fn(_build.load("slstm"), _SYMBOLS[dtype], n_ptrs=6,
                        n_ints=4)


@functools.cache
def _floor_fn():
    return _launch.c_fn(_build.load("slstm"), "slstm_step_floor", n_ptrs=1,
                        n_ints=4)


def _layout(info) -> dict:
    path, rows, size, active = list(info)
    if path == 0:
        return {"path": "l2"}
    return {"path": "cluster", "rows_per_cluster": rows,
            "cluster_size": size, "active_clusters": active}


def slstm_sequence(gates_x: torch.Tensor, r: torch.Tensor, b: torch.Tensor,
                   *, n_heads: int) -> torch.Tensor:
    """gates_x (B, S, 4d) f32 | bf16 × r (4, H, blk, blk) f32 × b (4d,) f32
    -> h (B, S, d) in the gates' dtype on the card: the stabilised exp-gate
    sLSTM cell from h = c = n = 0, m = -1e30, with f32 state and sums."""
    global launches, last_launch
    name = "slstm_sequence"
    if gates_x.dim() != 3 or gates_x.shape[2] % 4:
        raise ValueError(f"{name}: gates_x {tuple(gates_x.shape)} is not "
                         "(B, S, 4d)")
    bsz, s, d4 = gates_x.shape
    d = d4 // 4
    if n_heads <= 0 or d % n_heads:
        raise ValueError(f"{name}: d = {d} is not a multiple of n_heads = "
                         f"{n_heads}")
    blk = d // n_heads
    if tuple(r.shape) != (4, n_heads, blk, blk) or tuple(b.shape) != (d4,):
        raise ValueError(f"{name}: shapes r {tuple(r.shape)}, b "
                         f"{tuple(b.shape)} for d = {d}, {n_heads} heads")
    _launch.check_tensors(name, gates_x=gates_x, r=r, b=b)
    _launch.check_dtypes(name, gates_x=(gates_x, *_SYMBOLS),
                         r=(r, torch.float32), b=(b, torch.float32))
    out = torch.empty((bsz, s, d), dtype=gates_x.dtype, device=gates_x.device)
    if bsz == 0 or s == 0:
        return out
    # the l2 path's h ping, h pong, c, n, m: each (B, d) f32, written before
    # it is read
    scratch = torch.empty((5, bsz, d), dtype=torch.float32,
                          device=gates_x.device)
    info = (ctypes.c_int * 4)()
    _launch.launch(name, _fn(gates_x.dtype), gates_x.device,
                   gates_x.data_ptr(), r.data_ptr(), b.data_ptr(),
                   out.data_ptr(), scratch.data_ptr(), ctypes.addressof(info),
                   bsz, s, d, n_heads)
    last_launch = _layout(info)
    with _launch.count_lock:
        launches += 1
        path_launches[last_launch["path"]] += 1
    return out


def step_floor(bsz: int, s: int, d: int, n_heads: int,
               device: torch.device) -> dict:
    """Launch the cluster path's step floor at this shape (a measurement,
    not counted in ``launches``): the same clusters doing only the S steps'
    h exchange and cluster barriers, with no product and no cell.  Returns
    the layout; raises where the shape takes the l2 path."""
    info = (ctypes.c_int * 4)()
    _launch.launch("slstm_step_floor", _floor_fn(), device,
                   ctypes.addressof(info), bsz, s, d, n_heads)
    return _layout(info)
