"""What every kernel wrapper checks before it launches, and the launch call.

Each wrapper takes CUDA tensors only (a CPU tensor goes to the plain version
in ``ops.py``, never here), contiguous, of the dtypes its kernel reads.  The
C entry point returns ``cudaGetLastError()`` after the launch; a non-zero
code raises here, so a launch the card refused is never mistaken for a
result.  Each wrapper bumps its launch counters under `count_lock`.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Sequence

import torch

#: guards every wrapper's launch counters: a sharded collection's fan-out
#: threads launch the same kernel at once, and ``n += 1`` on a module global
#: is not atomic
count_lock = threading.Lock()


def c_fn(lib: ctypes.CDLL, symbol: str, n_ptrs: int, n_ints: int) -> Callable:
    """``symbol`` of ``lib`` typed as (n_ptrs pointers, n_ints ints, the
    stream) -> int.  Pointers need c_void_p: ctypes would pass a bare int as
    32 bits and cut it."""
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_tensors(kernel: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor."""
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def check_dtypes(kernel: str, **want: Sequence) -> None:
    """want: name -> (tensor, allowed dtypes...)."""
    for name, (t, *dtypes) in want.items():
        if t.dtype not in dtypes:
            raise ValueError(f"{kernel}: {name} must be "
                             f"{' or '.join(map(str, dtypes))}, got {t.dtype}")


def launch(kernel: str, fn: Callable, device: torch.device, *args) -> None:
    """Call the C entry point on ``device``'s current stream; raise on a
    non-zero CUDA error code.  ``device`` is made current only when it is
    not already, and the stream is read as its raw handle: entering the
    device context and building a ``Stream`` object were most of this
    helper's host time (PERF.md, scripts/hamming_stage_cycles.py)."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
