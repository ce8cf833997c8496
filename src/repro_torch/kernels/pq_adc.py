"""PQ asymmetric distance scan: the CUDA kernel's wrapper
(``csrc/pq_adc.cu``, replacing the JAX package's Pallas ``pq_adc_kernel``).

``launches`` counts the kernel's launches in this process, and
``path_launches`` the same launches by the path taken: ``"query_lanes"``
(lane = query, the LUT query-minor in shared memory, no bank conflicts;
Q >= 32 with uint8 codes, m a multiple of 4 and k <= 256) or
``"row_lanes"`` (lane = code row; every other shape).  Both are bumped at
the launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, _launch

launches = 0
path_launches = {"query_lanes": 0, "row_lanes": 0}

# the query-lane path's tile of queries (csrc/pq_adc.cu kQTQ)
_TQ = 32


@functools.cache
def _fn():
    return _launch.c_fn(_build.load("pq_adc"), "pq_adc_f32", n_ptrs=5,
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
    # the query-lane path's LUTs, query-minor in tiles of 32 queries; the
    # kernel takes the row-lane path without it (and where its other
    # conditions fail)
    scratch = None
    if codes.dtype == torch.uint8 and nq >= _TQ and m % 4 == 0 and k <= 256:
        scratch = torch.empty((-(-nq // _TQ) * _TQ * m * k,),
                              dtype=torch.float32, device=lut.device)
    info = (ctypes.c_int * 1)()
    _launch.launch(name, _fn(), lut.device, lut.data_ptr(), codes.data_ptr(),
                   out.data_ptr(), None if scratch is None
                   else scratch.data_ptr(), ctypes.addressof(info), nq, n, m,
                   k, codes.element_size())
    with _launch.count_lock:
        launches += 1
        path_launches["query_lanes" if info[0] else "row_lanes"] += 1
    return out
