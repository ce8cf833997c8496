"""Code-domain fused gather + ADC for the PQ engine's wide-beam traversal:
the CUDA kernel's wrapper (``csrc/beam_gather_adc.cu``, replacing the JAX
package's Pallas ``beam_gather_adc_kernel``).

``launches`` counts the kernel's launches in this process; it is bumped at
the launch and nowhere else, so a run can show it went through the kernel.
"""

from __future__ import annotations

import functools

import torch

from . import _build, _launch

launches = 0


@functools.cache
def _fn():
    return _launch.c_fn(_build.load("beam_gather_adc"), "beam_gather_adc_f32",
                        n_ptrs=4, n_ints=6)


def beam_gather_adc(lut: torch.Tensor, ids: torch.Tensor,
                    codes: torch.Tensor) -> torch.Tensor:
    """lut (Q, m, k) f32 × ids (Q, L) i32 × codes (N, m) uint8 | int32 ->
    (Q, L) f32 on the card: out[q, l] = Σᵢ lut[q, i, codes[ids[q, l], i]].
    ids must lie in [0, N), codes in [0, k)."""
    global launches
    name = "beam_gather_adc"
    _launch.check_tensors(name, lut=lut, ids=ids, codes=codes)
    _launch.check_dtypes(name, lut=(lut, torch.float32),
                         ids=(ids, torch.int32),
                         codes=(codes, torch.uint8, torch.int32))
    if lut.dim() != 3 or ids.dim() != 2 or codes.dim() != 2 \
            or ids.shape[0] != lut.shape[0] or codes.shape[1] != lut.shape[1]:
        raise ValueError(f"{name}: shapes lut {tuple(lut.shape)}, ids "
                         f"{tuple(ids.shape)}, codes {tuple(codes.shape)}")
    (nq, m, k), length, n = lut.shape, ids.shape[1], codes.shape[0]
    out = torch.empty((nq, length), dtype=torch.float32, device=lut.device)
    if nq == 0 or length == 0:
        return out
    _launch.launch(name, _fn(), lut.device, lut.data_ptr(), ids.data_ptr(),
                   codes.data_ptr(), out.data_ptr(), nq, length, m, k, n,
                   codes.element_size())
    with _launch.count_lock:
        launches += 1
    return out
