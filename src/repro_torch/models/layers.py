"""Shared layers of the port's models: parameter init and norms.

Precision policy, as the JAX package's ``repro.models.layers``: params fp32,
compute in ``cfg.dtype`` (bf16 by default), norms accumulate in fp32.  Only
what the xLSTM blocks need is ported so far; attention, RoPE, the MLPs and
MoE are not (building such a block raises ``NotImplementedError``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .config import ModelConfig


def _init(t: torch.Tensor, generator: torch.Generator,
          scale=None) -> torch.Tensor:
    """Fill t in place with scale × a standard normal truncated to [-2, 2];
    scale defaults to 1/sqrt(fan-in) = 1/sqrt(t.shape[0])
    (``repro.models.layers._init``)."""
    scale = scale if scale is not None else 1.0 / (t.shape[0] ** 0.5)
    with torch.no_grad():
        nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=generator)
        return t.mul_(scale)


def constrain_batch(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The JAX package pins the batch dim to mesh axes here; the port runs
    on one device, so this is the identity."""
    return x


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``) parameters."""

    def __init__(self, cfg: ModelConfig, device, d: Optional[int] = None):
        super().__init__()
        d = d or cfg.d_model
        self.scale = nn.Parameter(torch.ones((d,), device=device))
        if cfg.norm_type == "layernorm":
            self.bias = nn.Parameter(torch.zeros((d,), device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            if hasattr(self, "bias"):
                self.bias.zero_()


def init_norm(cfg: ModelConfig, device, d: Optional[int] = None) -> Norm:
    return Norm(cfg, device, d)


def apply_norm(p: Norm, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The norm in fp32, cast back to x's dtype."""
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + 1e-6) * p.scale + p.bias
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + 1e-6) * p.scale
    return out.to(x.dtype)
