"""Blocked L2 / dot distance matrix: the CUDA kernel's wrapper
(``csrc/l2_distance.cu``, replacing the JAX package's Pallas
``l2_distance_kernel``).

``launches`` counts the kernel's launches in this process; it is bumped at
the launch and nowhere else.
"""

from __future__ import annotations

import functools

import torch

from . import _build, _launch

launches = 0

_MODES = {"l2": 0, "dot": 1}


@functools.cache
def _fn():
    return _launch.c_fn(_build.load("l2_distance"), "l2_distance_f32",
                        n_ptrs=3, n_ints=4)


def l2_distance(q: torch.Tensor, x: torch.Tensor, *,
                mode: str = "l2") -> torch.Tensor:
    """q (Q, D) × x (N, D) float32 -> (Q, N) float32 on the card:
    ‖q‖² + ‖x‖² − 2·q·x clamped at 0 (``"l2"``) or −q·x (``"dot"``), summed
    in fp32."""
    global launches
    name = "l2_distance"
    if mode not in _MODES:
        raise ValueError(f"{name}: mode {mode!r}; have {sorted(_MODES)}")
    _launch.check_tensors(name, q=q, x=x)
    _launch.check_dtypes(name, q=(q, torch.float32), x=(x, torch.float32))
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, x "
                         f"{tuple(x.shape)}")
    (nq, d), n = q.shape, x.shape[0]
    out = torch.empty((nq, n), dtype=torch.float32, device=q.device)
    if nq == 0 or n == 0:
        return out
    _launch.launch(name, _fn(), q.device, q.data_ptr(), x.data_ptr(),
                   out.data_ptr(), nq, n, d, _MODES[mode])
    launches += 1
    return out
