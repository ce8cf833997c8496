"""Fused gather-distance for wide-beam HNSW traversal: the CUDA kernel's
wrapper (``csrc/beam_gather.cu``, replacing the JAX package's Pallas
``beam_gather_kernel``).

``launches`` counts the kernel's launches in this process; it is bumped at
the launch and nowhere else, so a run can show it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

MODES = {"l2": 0, "dot": 1}

launches = 0


@functools.cache
def _fn():
    fn = _build.load("beam_gather").beam_gather_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def beam_gather(q: torch.Tensor, ids: torch.Tensor, corpus: torch.Tensor, *,
                mode: str = "l2") -> torch.Tensor:
    """q (Q, D) f32 × ids (Q, L) i32 × corpus (N, D) f32 -> (Q, L) f32, on
    the card: squared L2 (diff-square-sum) or negated inner product of each
    query against its gathered rows.  ids must lie in [0, N)."""
    global launches
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}")
    for name, t in (("q", q), ("ids", ids), ("corpus", corpus)):
        if t.device.type != "cuda":
            raise ValueError(f"beam_gather: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"beam_gather: {name} must be contiguous")
    if q.dtype != torch.float32 or corpus.dtype != torch.float32 \
            or ids.dtype != torch.int32:
        raise ValueError("beam_gather: q/corpus float32, ids int32")
    if q.dim() != 2 or ids.dim() != 2 or corpus.dim() != 2 \
            or ids.shape[0] != q.shape[0] or q.shape[1] != corpus.shape[1]:
        raise ValueError(f"beam_gather: shapes q {tuple(q.shape)}, ids "
                         f"{tuple(ids.shape)}, corpus {tuple(corpus.shape)}")
    (nq, d), l, n = q.shape, ids.shape[1], corpus.shape[0]
    out = torch.empty((nq, l), dtype=torch.float32, device=corpus.device)
    if nq == 0 or l == 0:
        return out
    with torch.cuda.device(corpus.device):
        stream = torch.cuda.current_stream(corpus.device).cuda_stream
        err = _fn()(q.data_ptr(), ids.data_ptr(), corpus.data_ptr(),
                    out.data_ptr(), nq, l, d, n, MODES[mode], stream)
    if err:
        raise RuntimeError(f"beam_gather launch failed: CUDA error {err}")
    launches += 1
    return out
