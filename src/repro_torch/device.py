"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.  The default is the card; a
    caller who wants the CPU says so.  Without CUDA, anything but an explicit
    CPU device raises instead of carrying on quietly on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the host")
    return dev
