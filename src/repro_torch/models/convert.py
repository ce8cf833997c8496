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

A train state carries across the same way (``train_state_to_numpy`` /
``train_state_from_numpy``: the reference's ``TrainState`` as
``{"params": tree, "opt": {"step", "m": tree, "v": tree}}``), and
``decay_mask`` / ``leaf_groups`` give each port tensor the properties of
the reference leaf it belongs to: its rank there, which decides AdamW's
weight decay, and the leaf itself, which holds one int8 compression scale.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..optim.adamw import AdamWState
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


def _from_tree(tree: Dict[str, Any], keys, cfg: ModelConfig
               ) -> Dict[str, torch.Tensor]:
    """{port key: CPU tensor} from a tree in the JAX layout; every leaf of
    the tree must have a place."""
    leaves = dict(_leaves(tree))
    out, used = {}, set()
    for key in keys:
        path, u = _source(key, cfg)
        if path not in leaves:
            raise KeyError(f"{key}: {'/'.join(path)} missing from the tree")
        arr = np.asarray(leaves[path])
        out[key] = torch.from_numpy(np.array(arr if u is None else arr[u]))
        used.add(path)
    extra = sorted("/".join(p) for p in set(leaves) - used)
    if extra:
        raise KeyError(f"tree leaves the model has no place for: {extra}")
    return out


def _to_tree(tensors: Dict[str, torch.Tensor], cfg: ModelConfig
             ) -> Dict[str, Any]:
    """The JAX layout of {port key: tensor}, as numpy arrays (a unit's
    tensors stacked in unit order)."""
    stacks: Dict[Tuple[str, ...], List[np.ndarray]] = {}
    tree: Dict[str, Any] = {}
    for key, t in tensors.items():
        path, u = _source(key, cfg)
        arr = t.detach().cpu().numpy()
        if u is None:
            _put(tree, path, arr)
        else:
            stacks.setdefault(path, []).append(arr)   # in unit order
    for path, arrs in stacks.items():
        _put(tree, path, np.stack(arrs))
    return tree


def from_numpy_params(tree: Dict[str, Any], cfg: ModelConfig, *,
                      device="cuda") -> Model:
    """The port's model holding the JAX tree's weights."""
    model = Model(cfg, resolve_device(device))
    model.load_state_dict(_from_tree(tree, model.state_dict(), cfg))
    return model


def to_numpy_params(model: Model) -> Dict[str, Any]:
    """The JAX package's tree layout, as numpy arrays."""
    return _to_tree(model.state_dict(), model.cfg)


def reference_leaf(key: str, cfg: ModelConfig) -> Tuple[str, bool]:
    """("/"-joined path of the reference leaf that holds the port tensor
    ``key``, whether that leaf stacks the units along a leading axis)."""
    path, u = _source(key, cfg)
    return "/".join(path), u is not None


def decay_mask(model: Model) -> Dict[str, bool]:
    """{parameter name: decayed}: the reference decays a leaf of rank >= 2
    of its own tree, where a unit's tensor has one more (stacked) axis."""
    cfg = model.cfg
    return {k: p.dim() + reference_leaf(k, cfg)[1] >= 2
            for k, p in model.named_parameters()}


def leaf_groups(model: Model) -> Dict[str, str]:
    """{parameter name: its reference leaf}: the tensors that share one
    compression scale."""
    return {k: reference_leaf(k, model.cfg)[0]
            for k, _ in model.named_parameters()}


def train_state_to_numpy(model: Model, opt) -> Dict[str, Any]:
    """The reference's ``TrainState`` tree, as numpy arrays: params, and
    AdamW's step (int32 scalar), m and v in the params' layout."""
    cfg = model.cfg
    return {"params": to_numpy_params(model),
            "opt": {"step": np.asarray(int(opt.step), dtype=np.int32),
                    "m": _to_tree(opt.m, cfg), "v": _to_tree(opt.v, cfg)}}


def train_state_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, *,
                           device="cuda"):
    """(model, AdamW state) on ``device`` from the reference's
    ``TrainState`` tree (``train_state_to_numpy``'s layout)."""
    dev = resolve_device(device)
    model = from_numpy_params(tree["params"], cfg, device=dev)
    keys = dict(model.named_parameters())
    moments = [{k: t.to(dev, torch.float32)
                for k, t in _from_tree(tree["opt"][name], keys, cfg).items()}
               for name in ("m", "v")]
    step = torch.tensor(int(np.asarray(tree["opt"]["step"])),
                        dtype=torch.int32, device=dev)
    return model, AdamWState(step=step, m=moments[0], v=moments[1])


def _put(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
