"""Fused gather + pairwise distances for the bulk build's Alg-4 prune: the
CUDA kernel's wrapper (``csrc/pair_gather.cu``, replacing the JAX package's
Pallas ``pair_gather_kernel``).

``launches`` counts the kernel's launches in this process; it is bumped at
the launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

MODES = {"l2": 0, "dot": 1}
MAX_C = 256          # candidates per node the kernel takes

launches = 0


@functools.cache
def _fn():
    fn = _build.load("pair_gather").pair_gather_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pair_gather(ids: torch.Tensor, corpus: torch.Tensor, *,
                mode: str = "l2") -> torch.Tensor:
    """ids (B, C) i32 × corpus (N, D) f32 -> (B, C, C) f32 on the card:
    for each node, the clamped squared L2 (norm expansion) or negated inner
    product among its C gathered rows.  ids must lie in [0, N)."""
    global launches
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}")
    for name, t in (("ids", ids), ("corpus", corpus)):
        if t.device.type != "cuda":
            raise ValueError(f"pair_gather: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"pair_gather: {name} must be contiguous")
    if corpus.dtype != torch.float32 or ids.dtype != torch.int32:
        raise ValueError("pair_gather: corpus float32, ids int32")
    if ids.dim() != 2 or corpus.dim() != 2:
        raise ValueError(f"pair_gather: shapes ids {tuple(ids.shape)}, "
                         f"corpus {tuple(corpus.shape)}")
    (b, c), (n, d) = ids.shape, corpus.shape
    if c > MAX_C:
        raise ValueError(f"pair_gather: C={c} > {MAX_C}")
    out = torch.empty((b, c, c), dtype=torch.float32, device=corpus.device)
    if b == 0 or c == 0:
        return out
    with torch.cuda.device(corpus.device):
        stream = torch.cuda.current_stream(corpus.device).cuda_stream
        err = _fn()(ids.data_ptr(), corpus.data_ptr(), out.data_ptr(),
                    b, c, d, n, MODES[mode], stream)
    if err:
        raise RuntimeError(f"pair_gather launch failed: CUDA error {err}")
    launches += 1
    return out
