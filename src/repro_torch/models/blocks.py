"""Block-level init/apply dispatch, train (full sequence) and decode paths:
the port of the JAX package's ``repro.models.blocks`` for the block types
ported so far, ``"mlstm"`` and ``"slstm"``.

Each block is pre-norm residual; mlstm/slstm are self-contained (their
FFN/gating is internal, following xLSTM).  Building any other block type
raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
from torch import nn

from . import layers as L
from . import recurrent as R
from .config import ModelConfig

PORTED_BLOCKS = ("mlstm", "slstm")


def check_ported(block_type: str) -> None:
    if block_type not in PORTED_BLOCKS:
        raise NotImplementedError(
            f"block type {block_type!r} is not ported to PyTorch yet "
            f"(ported: {', '.join(PORTED_BLOCKS)})")


class Block(nn.Module):
    """One pre-norm residual block: ``norm1`` and the ``mlstm`` or
    ``slstm`` body."""

    def __init__(self, cfg: ModelConfig, block_type: str, device):
        super().__init__()
        check_ported(block_type)
        self.block_type = block_type
        self.norm1 = L.init_norm(cfg, device)
        if block_type == "mlstm":
            self.mlstm = R.MLSTM(cfg, device)
        else:
            self.slstm = R.SLSTM(cfg, device)


def init_block(cfg: ModelConfig, block_type: str, device) -> Block:
    """The block's parameters, uninitialised: ``reset_parameters`` fills
    them (``model.init_params``), or a converter loads them."""
    return Block(cfg, block_type, device)


def apply_block_train(p: Block, x: torch.Tensor, cfg: ModelConfig,
                      block_type: str, *, force_ref: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux loss); the xLSTM blocks have no aux loss."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.apply_norm(p.norm1, x, cfg)
    if block_type == "mlstm":
        return x + R.apply_mlstm(p.mlstm, h, cfg), aux
    return x + R.apply_slstm(p.slstm, h, cfg, force_ref=force_ref), aux


def block_state_init(cfg: ModelConfig, block_type: str, batch: int,
                     cache_len: int, dtype: torch.dtype, device) -> Any:
    """The block's decode state (the recurrent blocks ignore cache_len)."""
    check_ported(block_type)
    if block_type == "mlstm":
        return R.mlstm_init_state(cfg, batch, dtype, device)
    return R.slstm_init_state(cfg, batch, device)


def apply_block_decode(p: Block, x_t: torch.Tensor, state: Any,
                       pos: torch.Tensor, cfg: ModelConfig,
                       block_type: str) -> Tuple[torch.Tensor, Any]:
    """x_t (B, 1, d); pos (B,). Returns (x_t, new_state)."""
    h = L.apply_norm(p.norm1, x_t, cfg)
    if block_type == "mlstm":
        delta, new_s = R.apply_mlstm_decode(p.mlstm, h[:, 0], state, cfg)
    else:
        delta, new_s = R.apply_slstm_decode(p.slstm, h[:, 0], state, cfg)
    return x_t + delta[:, None, :], new_s
