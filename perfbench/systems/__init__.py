"""System drivers: how a configuration's system is built from the
benchmark's inputs and called by the window.  A configuration names its
driver (``"system"``); the harness loads ``systems/<system>.py`` by that name.

A driver module has ``build(ctx) -> system``; the system has
``search(queries) -> (distances (B, k) float32, ids (B, k))`` as host arrays
(a batch ends with its ids on the host), ``counters()`` and ``close()``.
``ctx`` carries the configuration, the traffic mix, the seed, the device
and the inputs (``ctx.corpus``, the rows on the device), which the system
takes over.
"""

from __future__ import annotations

import importlib
from typing import Dict

#: the port's kernel wrapper modules whose ``*launches`` counters the
#: benchmark reads (each bumped at its kernel's launch and nowhere else)
KERNEL_MODULES = ("beam_gather", "beam_gather_adc", "beam_gather_hamming",
                  "bulk_prune", "hamming", "l2", "pq_adc", "slstm")


def launch_counters() -> Dict[str, int]:
    """{"<module>.<counter>": value} of every kernel launch counter of
    ``repro_torch.kernels``."""
    out = {}
    for name in KERNEL_MODULES:
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        for attr, value in vars(mod).items():
            if attr.endswith("launches") and isinstance(value, int):
                out[f"{name}.{attr}"] = value
    return out
