"""Weights between the JAX package's parameter tree and the port's model.

The JAX tree (``repro.models.init_params``, as numpy arrays) holds
``embed``, ``final_norm``, ``head`` and ``units[str(i)][...]`` with a leading
``n_units`` axis (the pattern's block ``i`` of every unit, stacked by
``jax.vmap``), plus ``tail[str(i)]`` when n_layers is not a multiple of the
pattern, and for encoder-decoder models ``enc_units["0"][...]`` (one
``"attn"`` block a unit, ``encoder_layers`` units) and ``enc_final_norm``.
The port's layer ``u·P + i`` is ``units[str(i)][...][u]`` and its encoder
layer ``u`` is ``enc_units["0"][...][u]``; the names below the layer are
the same dict keys in both.  Both directions copy the values exactly.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig
from .model import Model


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _source(key: str, cfg: ModelConfig) -> Tuple[Tuple[str, ...], Any]:
    """(path in the JAX tree, unit index or None) of a port state-dict key."""
    parts = tuple(key.split("."))
    if parts[0] == "enc_layers":
        return ("enc_units", "0") + parts[2:], int(parts[1])
    if parts[0] != "layers":
        return parts, None
    j, rest = int(parts[1]), parts[2:]
    p = len(cfg.block_pattern)
    scanned = cfg.n_units * p
    if j < scanned:
        return ("units", str(j % p)) + rest, j // p
    return ("tail", str(j - scanned)) + rest, None


def from_numpy_params(tree: Dict[str, Any], cfg: ModelConfig, *,
                      device="cuda") -> Model:
    """The port's model holding the JAX tree's weights."""
    model = Model(cfg, resolve_device(device))
    leaves = dict(_leaves(tree))
    state, used = {}, set()
    for key in model.state_dict():
        path, u = _source(key, cfg)
        if path not in leaves:
            raise KeyError(f"{key}: {'/'.join(path)} missing from the tree")
        arr = np.asarray(leaves[path])
        state[key] = torch.from_numpy(np.array(arr if u is None else arr[u]))
        used.add(path)
    extra = sorted("/".join(p) for p in set(leaves) - used)
    if extra:
        raise KeyError(f"tree leaves the model has no place for: {extra}")
    model.load_state_dict(state)
    return model


def to_numpy_params(model: Model) -> Dict[str, Any]:
    """The JAX package's tree layout, as numpy arrays."""
    cfg = model.cfg
    stacks: Dict[Tuple[str, ...], List[np.ndarray]] = {}
    tree: Dict[str, Any] = {}
    for key, t in model.state_dict().items():
        path, u = _source(key, cfg)
        arr = t.detach().cpu().numpy()
        if u is None:
            _put(tree, path, arr)
        else:
            stacks.setdefault(path, []).append(arr)   # in unit order
    for path, arrs in stacks.items():
        _put(tree, path, np.stack(arrs))
    return tree


def _put(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
