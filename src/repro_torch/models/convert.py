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

A train state carries across the same way (``train_state_to_numpy``: the
reference's ``TrainState`` as ``{"params": tree, "opt": {"step", "m": tree,
"v": tree}}``; ``load_flat_state`` back from its flat keys, a placed
model's blocks at any mesh), and
``decay_mask`` / ``leaf_groups`` give each port tensor the properties of
the reference leaf it belongs to: its rank there, which decides AdamW's
weight decay, and the leaf itself, which holds one int8 compression scale.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..distributed.sharding import Placement
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
    """The JAX package's tree layout, as numpy arrays (a placed model's
    whole tensors: every rank calls it)."""
    return _to_tree(whole_tensors(model, dict(model.named_parameters())),
                    model.cfg)


def reference_slot(key: str, cfg: ModelConfig
                   ) -> Tuple[Tuple[str, ...], Any]:
    """(path of the reference leaf that holds the port tensor ``key``, its
    index along the leaf's stacked unit dim, or None for a leaf that
    stacks nothing)."""
    return _source(key, cfg)


def reference_shapes(model: Model) -> Dict[str, Any]:
    """The reference's parameter tree of shapes: each leaf's, a unit's
    stacking its layers along a leading dim.  The model's tensors may be
    meta ones; a placed model's count at their whole shape."""
    cfg = model.cfg
    pl = getattr(model, "placement", None)
    stacks: Dict[Tuple[str, ...], Any] = {}
    for key, p in model.named_parameters():
        shape = pl.shapes[key] if pl is not None else tuple(p.shape)
        path, u = _source(key, cfg)
        if u is None:
            stacks[path] = shape
        else:
            stacks.setdefault(path, [0, shape])[0] += 1
    tree: Dict[str, Any] = {}
    for path, v in stacks.items():
        _put(tree, path, v if isinstance(v, tuple) else (v[0],) + v[1])
    return tree


def train_state_shapes(model: Model) -> Dict[str, Any]:
    """The shapes of the model's train state in the reference's tree
    (``params``, ``opt/step``, ``opt/m``, ``opt/v``), from
    ``reference_shapes``."""
    tree = reference_shapes(model)
    return {"params": tree, "opt": {"step": (), "m": tree, "v": tree}}


def tensor_specs(model: Model, policy) -> Dict[str, Tuple[Any, ...]]:
    """{port tensor name: spec}: the spec of its reference leaf (through
    ``policy.spec_tree`` of the whole train state, which logs every leaf's
    decision as the reference's does), less the unit dim of a stacked
    leaf."""
    specs = policy.spec_tree(train_state_shapes(model))["params"]
    out = {}
    for name, _ in model.named_parameters():
        path, u = _source(name, model.cfg)
        spec = specs
        for k in path:
            spec = spec[k]
        out[name] = tuple(spec[1:] if u is not None else spec)
    return out


def placement(model: Model, policy, *, batch_split: bool = True
              ) -> Placement:
    """The ``Placement`` of the model's tensors by ``policy`` (each its
    reference leaf's spec, ``tensor_specs``); ``batch_split``: whether the
    ranks of the batch axes hold different rows."""
    return Placement(policy, tensor_specs(model, policy),
                     {k: tuple(p.shape) for k, p in model.named_parameters()},
                     batch_split=batch_split)


def whole_tensors(model: Model, tensors: Dict[str, torch.Tensor], *,
                  keep: bool = True) -> Dict[str, torch.Tensor]:
    """{name: the whole tensor} of a placed model's blocks (``tensors``:
    its parameters, or AdamW moments keyed like them), gathered one at a
    time: a collective every rank calls; with ``keep=False`` the rank takes
    part and keeps nothing.  An unplaced model's tensors as they are."""
    pl = getattr(model, "placement", None)
    if pl is None or pl.trivial:
        return dict(tensors) if keep else {}
    out = {}
    for k, t in tensors.items():
        full = pl.full(k, t)
        if keep:
            out[k] = full.cpu()
        del full
    return out


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


def train_state_to_numpy(model: Model, opt, *, keep: bool = True
                         ) -> Dict[str, Any]:
    """The reference's ``TrainState`` tree, as numpy arrays: params, and
    AdamW's step (int32 scalar), m and v in the params' layout.  A placed
    model's tensors are gathered one at a time (every rank calls it; with
    ``keep=False`` a rank takes part and gets None)."""
    cfg = model.cfg
    trees = [_to_tree(whole_tensors(model, t, keep=keep), cfg) for t in
             (dict(model.named_parameters()), opt.m, opt.v)]
    if not keep:
        return None
    return {"params": trees[0],
            "opt": {"step": np.asarray(int(opt.step), dtype=np.int32),
                    "m": trees[1], "v": trees[2]}}


def load_flat_state(model: Model, opt, flat: Dict[str, np.ndarray]):
    """Fill a train state in place from the reference's flat keys
    (``params/units/<i>/...``, ``opt/m/...``, ``opt/v/...``,
    ``opt/step``), each tensor with its layer of a stacked leaf and, on a
    placed model, this rank's block of it; a key ``flat`` lacks keeps the
    state's value (the reference's ``_unflatten_state``).  Returns the
    AdamW state with the restored step."""
    cfg = model.cfg
    pl = getattr(model, "placement", None)
    groups = (("params", dict(model.named_parameters())), ("opt/m", opt.m),
              ("opt/v", opt.v))
    with torch.no_grad():
        for prefix, tensors in groups:
            for name, t in tensors.items():
                path, u = _source(name, cfg)
                key = "/".join((prefix,) + path)
                if key not in flat:
                    continue
                arr = np.asarray(flat[key])
                full = torch.from_numpy(np.ascontiguousarray(
                    arr if u is None else arr[u]))
                if pl is not None:
                    full = pl.shard(name, full)
                if tuple(full.shape) != tuple(t.shape):
                    raise ValueError(f"{key}: {tuple(full.shape)} for "
                                     f"{name} {tuple(t.shape)}")
                t.copy_(full)
    step = opt.step
    if "opt/step" in flat:
        step = torch.tensor(int(np.asarray(flat["opt/step"])),
                            dtype=torch.int32, device=opt.step.device)
    return AdamWState(step=step, m=opt.m, v=opt.v)


def _put(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
