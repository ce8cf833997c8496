"""PQ asymmetric distance scan: the CUDA kernel's wrapper
(``csrc/pq_adc.cu``, replacing the JAX package's Pallas ``pq_adc_kernel``).

``launches`` counts the kernel's launches in this process; it is bumped at
the launch and nowhere else.
"""

from __future__ import annotations

import functools

import torch

from . import _build, _launch

launches = 0


@functools.cache
def _fn():
    return _launch.c_fn(_build.load("pq_adc"), "pq_adc_f32", n_ptrs=3,
                        n_ints=5)


def pq_adc(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut (Q, m, k) f32 × codes (N, m) uint8 | int32 -> (Q, N) f32 on the
    card: out[q, n] = Σᵢ lut[q, i, codes[n, i]].  codes must lie in [0, k)."""
    global launches
    name = "pq_adc"
    _launch.check_tensors(name, lut=lut, codes=codes)
    _launch.check_dtypes(name, lut=(lut, torch.float32),
                         codes=(codes, torch.uint8, torch.int32))
    if lut.dim() != 3 or codes.dim() != 2 or codes.shape[1] != lut.shape[1]:
        raise ValueError(f"{name}: shapes lut {tuple(lut.shape)}, codes "
                         f"{tuple(codes.shape)}")
    (nq, m, k), n = lut.shape, codes.shape[0]
    out = torch.empty((nq, n), dtype=torch.float32, device=lut.device)
    if nq == 0 or n == 0:
        return out
    _launch.launch(name, _fn(), lut.device, lut.data_ptr(), codes.data_ptr(),
                   out.data_ptr(), nq, n, m, k, codes.element_size())
    launches += 1
    return out
