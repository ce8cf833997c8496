"""Architecture config registry: ``get_config("qwen2-1.5b")`` etc.

One module per assigned architecture (+ the paper's own quantixar_db).  Each
module exposes CONFIG (full published size) and SMOKE (reduced same-family
config for CPU tests).  The modules are pure data, copied from the JAX
package's ``repro.configs`` so that both packages answer alike; the port's
models build only the xLSTM blocks so far (``repro_torch.models``).
"""

from __future__ import annotations

import importlib
from typing import List

_ARCHS = {
    "qwen2-1.5b": "qwen2_1_5b",
    "qwen3-4b": "qwen3_4b",
    "starcoder2-15b": "starcoder2_15b",
    "stablelm-3b": "stablelm_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mixtral-8x7b": "mixtral_8x7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "xlstm-1.3b": "xlstm_1_3b",
    "chameleon-34b": "chameleon_34b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


def arch_ids() -> List[str]:
    return list(_ARCHS)


def _module(arch: str):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE
