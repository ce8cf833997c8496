"""Gradient compression with error feedback: the port of the JAX package's
``repro.optim.compression``.

Deterministic symmetric int8 quantization per leaf (scale = max|g| / 127)
is biased, so an error-feedback accumulator carries the residual into the
next step (EF-SGD).  In a deployment the int8 codes and the scales are
what crosses the wire; here the quantize / dequantize pair is that boundary
(``launch/train.py --grad-compress``: loss -> grads -> compress /
decompress -> update).

One scale per reference leaf: the reference quantizes each leaf of its own
tree, whose scanned units stack a parameter of every unit along a leading
``n_units`` axis, so the port's per-layer tensors of one stacked leaf share
one scale (``leaves``: name -> the reference leaf it belongs to,
``models.convert.leaf_groups``).  On a placed state each rank holds blocks
of the gradient and of the error feedback (placed like their parameter):
a leaf's scale is then its largest |value| over the mesh, one all-reduce
(max) of every leaf's local maximum.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

Params = Dict[str, torch.Tensor]


def init_error_feedback(params: Mapping[str, torch.Tensor]) -> Params:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def leaf_scale(max_abs: torch.Tensor) -> torch.Tensor:
    """The symmetric int8 scale of a leaf whose largest |value| is
    ``max_abs``."""
    return torch.clamp_min(max_abs, 1e-12) / 127.0


def quantize_leaf(g: torch.Tensor, scale: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 at the leaf's ``scale`` (``leaf_scale``; ``g`` may be
    one tensor of a larger leaf): (codes int8, scale).  ``torch.round``
    rounds half to even, as ``jnp.round``."""
    codes = torch.clamp(torch.round(g.float() / scale), -127,
                        127).to(torch.int8)
    return codes, scale


def dequantize_leaf(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.float() * scale


def _groups(keys, leaves: Mapping[str, str]) -> Dict[str, list]:
    out: Dict[str, list] = {}
    for k in keys:
        out.setdefault(leaves[k], []).append(k)
    return out


def compress_decompress(grads: Mapping[str, torch.Tensor],
                        ef: Mapping[str, torch.Tensor], *,
                        leaves: Mapping[str, str],
                        placement=None) -> Tuple[Params, Params]:
    """int8 round trip with error feedback, in place: the dequantized grads
    (what the receiving side applies) are written into the given f32
    ``grads``, the new error feedback (what the wire dropped) into ``ef``
    (neither is held twice).  Returns (grads, ef).  ``placement``: the
    ``Placement`` whose blocks ``grads`` and ``ef`` are."""
    with torch.no_grad():
        groups = list(_groups(grads, leaves).values())
        # each leaf's scale first, one tensor's target at a time
        maxima = torch.stack([torch.stack(
            [(grads[k].float() + ef[k]).abs().max() for k in members])
            .max() for members in groups])
        if placement is not None:
            placement.all_max(maxima)
        for members, mx in zip(groups, maxima):
            scale = leaf_scale(mx)
            for k in members:
                target = grads[k].float() + ef[k]
                codes, _ = quantize_leaf(target, scale)
                d = dequantize_leaf(codes, scale)
                ef[k].copy_(target - d)
                grads[k].copy_(d)
    return dict(grads), dict(ef)


def compression_ratio(grads: Mapping[str, torch.Tensor], *,
                      leaves: Mapping[str, str]) -> float:
    """fp32 bytes / (int8 codes + one f32 scale a leaf): the wire saving."""
    f32 = sum(g.numel() * 4 for g in grads.values())
    i8 = sum(g.numel() for g in grads.values()) \
        + 4 * len(_groups(grads, leaves))
    return f32 / i8
