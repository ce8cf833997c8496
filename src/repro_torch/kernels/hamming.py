"""Packed Hamming distance scan: the CUDA kernel's wrapper
(``csrc/hamming.cu``, replacing the JAX package's Pallas
``hamming_kernel``).

Packed words are int32 tensors holding the uint32 bits; the kernel reads
them as uint32.  ``launches`` counts the kernel's launches in this process;
it is bumped at the launch and nowhere else.
"""

from __future__ import annotations

import functools

import torch

from . import _build, _launch

launches = 0


@functools.cache
def _fn():
    return _launch.c_fn(_build.load("hamming"), "hamming_u32", n_ptrs=3,
                        n_ints=3)


def hamming(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """q (Q, W) × x (N, W), int32 words with uint32 bits -> (Q, N) int32 on
    the card: Σ_w popcount(q[q, w] ^ x[n, w])."""
    global launches
    name = "hamming"
    _launch.check_tensors(name, q=q, x=x)
    _launch.check_dtypes(name, q=(q, torch.int32), x=(x, torch.int32))
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, x "
                         f"{tuple(x.shape)}")
    (nq, w), n = q.shape, x.shape[0]
    out = torch.empty((nq, n), dtype=torch.int32, device=q.device)
    if nq == 0 or n == 0:
        return out
    _launch.launch(name, _fn(), q.device, q.data_ptr(), x.data_ptr(),
                   out.data_ptr(), nq, n, w)
    with _launch.count_lock:
        launches += 1
    return out
