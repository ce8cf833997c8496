"""sLSTM recurrence over a sequence: the CUDA kernels' wrappers
(``csrc/slstm.cu``, replacing the JAX package's Pallas
``slstm_sequence_kernel``; ``csrc/slstm_backward.cu``, its backward), and
``SLSTMSequence``, the autograd function over both.

``launches`` counts the forward kernel's launches in this process, one per
sequence (each launch walks every timestep), through either entry: the
serving one (``slstm_sequence``) and the one that also writes what the
backward reads (``slstm_sequence_save``, counted again in
``save_launches``).  ``path_launches`` splits them by the path the kernel
took: ``"cluster"`` (one thread-block cluster per head and batch-row group,
R on chip, h through distributed shared memory; every head width that is a
multiple of 32 up to 512) or ``"l2"`` (the cooperative launch that reads R
from L2 or shared memory and ends each step with a grid barrier; the other
widths).  ``backward_launches`` counts the backward kernel's (B8ᵀ), and
``backward_path_launches`` splits them the same way: ``"cluster"`` (one
cluster per head and batch-row group, R on chip, the partial sums of the
recurrent term through distributed shared memory) for the same widths, the
head width alone deciding, or ``"l2"`` (the cooperative launch with a grid
barrier a step).  Each is bumped at its launch and nowhere else.
``last_launch`` and ``last_backward_launch`` hold the last forward and
backward launch's layout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build, _launch, ref

launches = 0
save_launches = 0
backward_launches = 0
path_launches = {"cluster": 0, "l2": 0}
backward_path_launches = {"cluster": 0, "l2": 0}
# {"path", "rows_per_cluster", "cluster_size", "active_clusters"}
last_launch: dict = {}
last_backward_launch: dict = {}

_SYMBOLS = {torch.float32: "slstm_sequence_f32",
            torch.bfloat16: "slstm_sequence_bf16"}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _fn(dtype: torch.dtype):
    return _launch.c_fn(_build.load("slstm"), _SYMBOLS[dtype], n_ptrs=6,
                        n_ints=4)


@functools.cache
def _save_fn(dtype: torch.dtype):
    return _launch.c_fn(_build.load("slstm"),
                        f"slstm_sequence_save_{_SUFFIX[dtype]}", n_ptrs=7,
                        n_ints=4)


@functools.cache
def _backward_fn(dtype: torch.dtype):
    return _launch.c_fn(_build.load("slstm_backward"),
                        f"slstm_backward_{_SUFFIX[dtype]}", n_ptrs=7,
                        n_ints=4)


# the step floor's entry point in each source
_FLOOR = {"slstm": "slstm_step_floor",
          "slstm_backward": "slstm_backward_step_floor"}


@functools.cache
def _floor_fn(source: str):
    return _launch.c_fn(_build.load(source), _FLOOR[source], n_ptrs=1,
                        n_ints=4)


@functools.cache
def _backward_takes_cluster_fn():
    fn = _build.load("slstm_backward").slstm_backward_takes_cluster
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def _layout(info) -> dict:
    path, rows, size, active = list(info)
    if path == 0:
        return {"path": "l2"}
    return {"path": "cluster", "rows_per_cluster": rows,
            "cluster_size": size, "active_clusters": active}


def _check(name: str, gates_x: torch.Tensor, r: torch.Tensor,
           b: torch.Tensor, n_heads: int):
    """(B, S, d) of a valid call; raises on anything the kernels do not
    take."""
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
    return bsz, s, d


def _forward(name: str, gates_x: torch.Tensor, r: torch.Tensor,
             b: torch.Tensor, n_heads: int, save: bool):
    global launches, save_launches, last_launch
    bsz, s, d = _check(name, gates_x, r, b, n_heads)
    out = torch.empty((bsz, s, d), dtype=gates_x.dtype, device=gates_x.device)
    saved = torch.empty((8, bsz, s, d) if save else (0,),
                        dtype=torch.float32, device=gates_x.device)
    if bsz == 0 or s == 0:
        return out, saved
    # the l2 path's h ping, h pong, c, n, m: each (B, d) f32, written before
    # it is read
    scratch = torch.empty((5, bsz, d), dtype=torch.float32,
                          device=gates_x.device)
    info = (ctypes.c_int * 4)()
    args = (gates_x.data_ptr(), r.data_ptr(), b.data_ptr(), out.data_ptr(),
            scratch.data_ptr())
    if save:
        _launch.launch(name, _save_fn(gates_x.dtype), gates_x.device, *args,
                       saved.data_ptr(), ctypes.addressof(info), bsz, s, d,
                       n_heads)
    else:
        _launch.launch(name, _fn(gates_x.dtype), gates_x.device, *args,
                       ctypes.addressof(info), bsz, s, d, n_heads)
    last_launch = _layout(info)
    with _launch.count_lock:
        launches += 1
        save_launches += save
        path_launches[last_launch["path"]] += 1
    return out, saved


def slstm_sequence(gates_x: torch.Tensor, r: torch.Tensor, b: torch.Tensor,
                   *, n_heads: int) -> torch.Tensor:
    """gates_x (B, S, 4d) f32 | bf16 × r (4, H, blk, blk) f32 × b (4d,) f32
    -> h (B, S, d) in the gates' dtype on the card: the stabilised exp-gate
    sLSTM cell from h = c = n = 0, m = -1e30, with f32 state and sums."""
    return _forward("slstm_sequence", gates_x, r, b, n_heads, False)[0]


def slstm_sequence_save(gates_x: torch.Tensor, r: torch.Tensor,
                        b: torch.Tensor, *, n_heads: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``slstm_sequence`` that also writes what its backward reads: (h,
    saved (8, B, S, d) f32, the fields of ``ref.SLSTM_SAVED``).  The same
    launch and path as the serving entry with one more store per field in
    the cell, so h has the serving entry's bits."""
    return _forward("slstm_sequence_save", gates_x, r, b, n_heads, True)


def slstm_backward(dh: torch.Tensor, saved: torch.Tensor, r: torch.Tensor,
                   *, n_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B8ᵀ: dh (B, S, d) f32 | bf16, the cotangent of h, × saved (8, B, S,
    d) f32 × r (4, H, blk, blk) f32 -> (dgates (B, S, 4d) in dh's dtype,
    dpre (B, S, 4d) f32, the same values before the cast; for f32 the two
    are one tensor).  One launch walks t = S-1 .. 0 carrying dc, dn, dm in
    f32: a cluster launch where the head width d / n_heads is a multiple
    of 32 up to 512 (the C side's rule), else the cooperative one."""
    global backward_launches, last_backward_launch
    name = "slstm_backward"
    if dh.dim() != 3 or tuple(saved.shape) != (8, *dh.shape):
        raise ValueError(f"{name}: dh {tuple(dh.shape)}, saved "
                         f"{tuple(saved.shape)} is not (8, B, S, d)")
    bsz, s, d = dh.shape
    if n_heads <= 0 or d % n_heads or tuple(r.shape) != (
            4, n_heads, d // n_heads, d // n_heads):
        raise ValueError(f"{name}: r {tuple(r.shape)} for d = {d}, "
                         f"{n_heads} heads")
    _launch.check_tensors(name, dh=dh, saved=saved, r=r)
    _launch.check_dtypes(name, dh=(dh, *_SYMBOLS),
                         saved=(saved, torch.float32), r=(r, torch.float32))
    dpre = torch.empty((bsz, s, 4 * d), dtype=torch.float32, device=dh.device)
    dgates = dpre if dh.dtype == torch.float32 else torch.empty_like(
        dpre, dtype=dh.dtype)
    if bsz == 0 or s == 0:
        return dgates, dpre
    # the l2 path's dc, dn, dm carried from step t + 1: each (B, d) f32,
    # written before it is read (the cluster path keeps them in registers)
    carry = (None if _backward_takes_cluster_fn()(d // n_heads) else
             torch.empty((3, bsz, d), dtype=torch.float32, device=dh.device))
    info = (ctypes.c_int * 4)()
    _launch.launch(name, _backward_fn(dh.dtype), dh.device, dh.data_ptr(),
                   saved.data_ptr(), r.data_ptr(), dpre.data_ptr(),
                   dgates.data_ptr() if dgates is not dpre else None,
                   None if carry is None else carry.data_ptr(),
                   ctypes.addressof(info), bsz, s, d, n_heads)
    last_backward_launch = _layout(info)
    with _launch.count_lock:
        backward_launches += 1
        backward_path_launches[last_backward_launch["path"]] += 1
    return dgates, dpre


def operations(bsz: int, s: int, d: int, n_heads: int) -> float:
    """B8's (and B8ᵀ's) operations: the recurrent product of every step,
    2 · B · S · 4d · blk (the formula of their bound in
    ``chip_smoke.py``)."""
    return 2.0 * bsz * s * 4 * d * (d // n_heads)


def slstm_meta(gates_x: torch.Tensor, n_heads: int, save: bool):
    """B8's meta branch: (h, saved) of the kernel's shapes and dtypes on the
    meta device (saved (8, B, S, d) f32 where ``save``, as the saving entry
    writes it), its operations counted in ``ops.meta_operations``; no
    launch."""
    from .ops import count_meta
    bsz, s, d4 = gates_x.shape
    d = d4 // 4
    count_meta("slstm", operations(bsz, s, d, n_heads))
    h = torch.empty((bsz, s, d), dtype=gates_x.dtype, device="meta")
    saved = torch.empty((8, bsz, s, d) if save else (0,),
                        dtype=torch.float32, device="meta")
    return h, saved


def slstm_backward_meta(dh: torch.Tensor, n_heads: int):
    """B8ᵀ's meta branch: (dgates, dpre) of the kernel's shapes and dtypes
    on the meta device, its operations counted; no launch."""
    from .ops import count_meta
    bsz, s, d = dh.shape
    count_meta("slstm_backward", operations(bsz, s, d, n_heads))
    dpre = torch.empty((bsz, s, 4 * d), dtype=torch.float32, device="meta")
    dgates = dpre if dh.dtype == torch.float32 else torch.empty_like(
        dpre, dtype=dh.dtype)
    return dgates, dpre


class SLSTMSequence(torch.autograd.Function):
    """h = the sLSTM sequence of (gates_x, r, b), differentiable in all
    three.  ``plain`` (CPU tensors, or ``force_ref``) runs the plain forward
    and reverse loop of ``ref.py``; None (meta tensors) B8's and B8ᵀ's meta
    branches; otherwise B8's saving entry forward and B8ᵀ backward, which
    raise on a failed build or launch.  dr and db are one product and one
    sum over the saved h and dpre after any of them."""

    @staticmethod
    def forward(ctx, gates_x, r, b, n_heads: int, plain):
        if plain is None:
            h, saved = slstm_meta(gates_x, n_heads, save=True)
        elif plain:
            h, saved = ref.slstm_sequence_save_ref(gates_x, r, b, n_heads)
        else:
            h, saved = slstm_sequence_save(gates_x, r, b, n_heads=n_heads)
        ctx.save_for_backward(r, saved)
        ctx.n_heads, ctx.plain, ctx.dtype = n_heads, plain, gates_x.dtype
        return h

    @staticmethod
    def backward(ctx, dh):
        r, saved = ctx.saved_tensors
        if ctx.plain is None:
            dgates, dpre = slstm_backward_meta(dh, ctx.n_heads)
        elif ctx.plain:
            dgates, dpre = ref.slstm_sequence_backward_ref(
                dh, saved, r, ctx.n_heads, ctx.dtype)
        else:
            dgates, dpre = slstm_backward(dh.contiguous(), saved, r,
                                          n_heads=ctx.n_heads)
        dr = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dr, db = ref.slstm_param_grads(saved, dpre, ctx.n_heads)
        return dgates, dr, db, None, None


def step_floor(bsz: int, s: int, d: int, n_heads: int,
               device: torch.device) -> dict:
    """Launch the cluster path's step floor at this shape (a measurement,
    not counted in ``launches``): the same clusters doing only the S steps'
    h exchange and cluster barriers, with no product and no cell.  Returns
    the layout; raises where the shape takes the l2 path."""
    return _step_floor("slstm", bsz, s, d, n_heads, device)


def backward_step_floor(bsz: int, s: int, d: int, n_heads: int,
                        device: torch.device) -> dict:
    """B8ᵀ's ``step_floor``: its cluster path's launch at this shape doing
    only the S steps' exchange of partial sums and its waits, with no
    product and no cell (not counted in ``backward_launches``).  Returns
    the layout; raises where the width takes the l2 path."""
    return _step_floor("slstm_backward", bsz, s, d, n_heads, device)


def _step_floor(source: str, bsz: int, s: int, d: int, n_heads: int,
                device: torch.device) -> dict:
    info = (ctypes.c_int * 4)()
    _launch.launch(_FLOOR[source], _floor_fn(source), device,
                   ctypes.addressof(info), bsz, s, d, n_heads)
    return _layout(info)
