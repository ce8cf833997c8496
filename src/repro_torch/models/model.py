"""Model assembly: embeddings, the layer stack, logits, decode — the port of
the JAX package's ``repro.models.model``, decoder-only.

The JAX package stacks each pattern unit's parameters along a leading
``n_units`` axis and scans over them; the port keeps the ``n_layers`` blocks
in one ``nn.ModuleList`` (layer ``u·P + i`` is block ``i`` of unit ``u``)
and runs them in order.  Encoder-decoder configs are not ported yet and
raise.  ``forward`` and ``decode_step`` serve (no autograd): training is a
later slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from . import blocks as B
from . import layers as L
from .config import ModelConfig


def layer_types(cfg: ModelConfig) -> List[str]:
    """The block type of every layer: the pattern cycled over n_layers (the
    JAX package's scanned units, then its tail)."""
    return [cfg.block_pattern[j % len(cfg.block_pattern)]
            for j in range(cfg.n_layers)]


class Model(nn.Module):
    """The decoder-only LM: ``embed`` (V, d), ``final_norm``, ``head``
    (d, V) unless tied, and ``layers``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.is_enc_dec:
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder models are not ported to "
                "PyTorch yet")
        for bt in dict.fromkeys(cfg.block_pattern):
            B.check_ported(bt)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            (cfg.vocab_size, cfg.d_model), dtype=torch.float32, device=device))
        self.final_norm = L.init_norm(cfg, device)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(torch.empty(
                (cfg.d_model, cfg.vocab_size), dtype=torch.float32,
                device=device))
        self.layers = nn.ModuleList(B.init_block(cfg, bt, device)
                                    for bt in layer_types(cfg))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.embed.normal_(generator=generator).mul_(0.02)
        self.final_norm.reset_parameters(generator)
        if not self.cfg.tie_embeddings:
            L._init(self.head, generator)
        for blk in self.layers:
            for m in (blk.norm1, getattr(blk, blk.block_type)):
                m.reset_parameters(generator)

    def forward(self, tokens: torch.Tensor, *, force_ref: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return forward(self, {"tokens": tokens}, self.cfg,
                       force_ref=force_ref)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device="cuda") -> Model:
    """A model with random weights drawn from ``generator`` (which must live
    on ``device``), with the JAX package's distributions: embed 0.02·N(0, 1),
    the matrices truncated normals scaled by 1/sqrt(fan-in)."""
    model = Model(cfg, resolve_device(device))
    model.reset_parameters(generator)
    return model


def embed_tokens(params: Model, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    # the rows, then the cast: the same values as casting the whole table
    return L.constrain_batch(
        params.embed[tokens.long()].to(cfg.activation_dtype), cfg)


def logits_from_hidden(params: Model, x: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    x = L.apply_norm(params.final_norm, x, cfg)
    w = params.embed.T if cfg.tie_embeddings else params.head
    return (x @ w.to(x.dtype)).float()


@torch.no_grad()
def forward(params: Model, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            *, force_ref: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill / scoring forward. batch: tokens (B, S) on the model's
    device.  Returns (logits (B, S, V) fp32, aux loss).  ``force_ref`` runs
    the sLSTM layers' plain recurrence instead of the kernel."""
    x = embed_tokens(params, batch["tokens"], cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in params.layers:
        x, a = B.apply_block_train(blk, x, cfg, blk.block_type,
                                   force_ref=force_ref)
        x = L.constrain_batch(x, cfg)
        aux = aux + a
    return logits_from_hidden(params, x, cfg), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    block_states: List[Any]   # one state per layer
    pos: torch.Tensor         # (B,) int32 next position to write


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype: Optional[torch.dtype] = None, *,
                      device="cuda") -> DecodeState:
    device = resolve_device(device)
    dtype = dtype or cfg.activation_dtype
    states = [B.block_state_init(cfg, bt, batch, cache_len, dtype, device)
              for bt in layer_types(cfg)]
    return DecodeState(block_states=states,
                       pos=torch.zeros((batch,), dtype=torch.int32,
                                       device=device))


@torch.no_grad()
def decode_step(params: Model, state: DecodeState, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, DecodeState]:
    """tokens (B, 1) -> (logits (B, 1, V) fp32, new state).  One cell step
    per recurrent layer, plain PyTorch (the JAX package has no kernel on
    this path)."""
    x = embed_tokens(params, tokens, cfg)
    new_states = []
    for blk, st in zip(params.layers, state.block_states):
        x, ns = B.apply_block_decode(blk, x, st, state.pos, cfg,
                                     blk.block_type)
        new_states.append(ns)
    logits = logits_from_hidden(params, x, cfg)
    return logits, state._replace(block_states=new_states,
                                  pos=state.pos + 1)
