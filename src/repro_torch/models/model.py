"""Model assembly: embeddings, the layer stack, the encoder of
encoder-decoder models, logits, decode — the port of the JAX package's
``repro.models.model``.

The JAX package stacks each pattern unit's parameters along a leading
``n_units`` axis and scans over them, then applies the ``tail`` blocks (the
layers past the last whole unit); the port keeps the ``n_layers`` decoder
blocks in one ``nn.ModuleList`` (layer ``u·P + i`` is block ``i`` of unit
``u``, the tail last) and runs them in order.  An encoder-decoder model adds
``enc_layers`` (``encoder_layers`` non-causal ``"attn"`` blocks) and
``enc_final_norm``; its decoder blocks carry cross-attention.  ``forward``
and ``encode`` run under the caller's grad mode: a train step
differentiates them, with each pattern unit recomputed in the backward
(``remat``, the reference's ``jax.checkpoint`` of the unit body), and every
serving caller runs them under ``torch.no_grad()``.  ``decode_step`` and
``precompute_cross_kv`` never record a graph.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import blocks as B
from . import layers as L
from .config import ModelConfig


def layer_types(cfg: ModelConfig) -> List[str]:
    """The block type of every decoder layer: the pattern cycled over
    n_layers (the JAX package's scanned units, then its tail)."""
    return [cfg.block_pattern[j % len(cfg.block_pattern)]
            for j in range(cfg.n_layers)]


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder's config, as the reference builds it."""
    return cfg.with_overrides(block_pattern=("attn",),
                              n_layers=cfg.encoder_layers, encoder_layers=0)


class Model(nn.Module):
    """The LM: ``embed`` (V, d), ``final_norm``, ``head`` (d, V) unless
    tied, ``layers``; encoder-decoder models add ``enc_layers`` and
    ``enc_final_norm``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            (cfg.vocab_size, cfg.d_model), dtype=torch.float32, device=device))
        self.final_norm = L.init_norm(cfg, device)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(torch.empty(
                (cfg.d_model, cfg.vocab_size), dtype=torch.float32,
                device=device))
        self.layers = nn.ModuleList(
            B.init_block(cfg, bt, device, with_cross=cfg.is_enc_dec)
            for bt in layer_types(cfg))
        if cfg.is_enc_dec:
            enc_cfg = encoder_config(cfg)
            self.enc_layers = nn.ModuleList(
                B.init_block(enc_cfg, bt, device)
                for bt in layer_types(enc_cfg))
            self.enc_final_norm = L.init_norm(cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.embed.normal_(generator=generator).mul_(0.02)
        if not self.cfg.tie_embeddings:
            L._init(self.head, generator)
        for m in self.children():        # norms, layers, encoder layers
            for blk in (m if isinstance(m, nn.ModuleList) else [m]):
                blk.reset_parameters(generator)

    def forward(self, tokens: torch.Tensor,
                frames: Optional[torch.Tensor] = None, *,
                force_ref: bool = False, remat: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        batch = {"tokens": tokens}
        if frames is not None:
            batch["frames"] = frames
        return forward(self, batch, self.cfg, force_ref=force_ref,
                       remat=remat)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device="cuda") -> Model:
    """A model with random weights drawn from ``generator`` (which must live
    on ``device``), with the JAX package's distributions: embed 0.02·N(0, 1),
    the matrices truncated normals scaled by 1/sqrt(leading dim), the
    router 0.02, the conv taps 0.5, biases 0, norm scales 1."""
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


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


def _apply_unit(blocks, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, causal: bool,
                enc_out: Optional[torch.Tensor],
                enc_pos: Optional[torch.Tensor], force_ref: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pattern unit (or the tail's blocks): (x, the unit's aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = L.constrain_batch(x, cfg)
    for blk in blocks:
        x, a = B.apply_block_train(blk, x, cfg, blk.block_type, positions,
                                   causal=causal, enc_out=enc_out,
                                   enc_pos=enc_pos, force_ref=force_ref)
        x = L.constrain_batch(x, cfg)
        aux = aux + a
    return x, aux


def _apply_stack(layers, n_units: int, p: int, x: torch.Tensor,
                 cfg: ModelConfig,
                 positions: torch.Tensor, *, causal: bool,
                 enc_out: Optional[torch.Tensor] = None,
                 enc_pos: Optional[torch.Tensor] = None,
                 force_ref: bool = False, remat: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's scan over ``n_units`` pattern units of ``p`` blocks,
    then the tail's blocks (without remat, as the reference applies them).  Under grad with
    ``remat`` each unit is recomputed in the backward
    (``torch.utils.checkpoint``), so only the units' inputs are kept."""
    rc = remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for u in range(n_units):
        args = (layers[u * p:(u + 1) * p], x, cfg, positions, causal,
                enc_out, enc_pos, force_ref)
        x, a = (checkpoint(_apply_unit, *args, use_reentrant=False) if rc
                else _apply_unit(*args))
        aux = aux + a
    for blk in layers[n_units * p:]:
        x, a = B.apply_block_train(blk, x, cfg, blk.block_type, positions,
                                   causal=causal, enc_out=enc_out,
                                   enc_pos=enc_pos, force_ref=force_ref)
        aux = aux + a
    return x, aux


def encode(params: Model, frames: torch.Tensor, cfg: ModelConfig, *,
           remat: bool = True) -> torch.Tensor:
    """The encoder stack over the frontend's frame embeddings (B, S_enc, d):
    non-causal self-attention with RoPE, then ``enc_final_norm``."""
    b, s, _ = frames.shape
    pos = _positions(b, s, frames.device)
    x = frames.to(cfg.activation_dtype)
    x, _ = _apply_stack(params.enc_layers, len(params.enc_layers), 1, x,
                        cfg, pos, causal=False, remat=remat)
    return L.apply_norm(params.enc_final_norm, x, cfg)


def forward(params: Model, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            *, force_ref: bool = False, remat: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill / scoring / training forward.  batch: tokens (B, S) [+ frames
    (B, S_enc, d) for encoder-decoder models] on the model's device.
    Returns (logits (B, S, V) fp32, aux loss).  ``force_ref`` runs the sLSTM
    layers' plain recurrence instead of the kernel; ``remat`` (under grad)
    recomputes each pattern unit in the backward."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = embed_tokens(params, tokens, cfg)
    enc_out = enc_pos = None
    if cfg.is_enc_dec:
        enc_out = encode(params, batch["frames"], cfg, remat=remat)
        enc_pos = _positions(b, enc_out.shape[1], tokens.device)
    x, aux = _apply_stack(params.layers, cfg.n_units, len(cfg.block_pattern),
                          x, cfg, positions, causal=True, enc_out=enc_out, enc_pos=enc_pos,
                          force_ref=force_ref, remat=remat)
    return logits_from_hidden(params, x, cfg), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    block_states: List[Any]   # one state per decoder layer
    pos: torch.Tensor         # (B,) int32 next position to write
    # encoder-decoder: one (k, v) (B, T, nkv, dh) per scanned unit
    cross_kv: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None


@torch.no_grad()
def precompute_cross_kv(params: Model, enc_out: torch.Tensor,
                        cfg: ModelConfig
                        ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each unit's cross K/V from the encoder output, projected by the
    unit's block 0 (which every block of the unit then decodes with)."""
    p = len(cfg.block_pattern)
    out = []
    for u in range(cfg.n_units):
        k, v, _ = B._cross_kv(params.layers[u * p].cross, enc_out, cfg, None)
        out.append((k, v))
    return out


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype: Optional[torch.dtype] = None, *,
                      enc_out: Optional[torch.Tensor] = None,
                      params: Optional[Model] = None,
                      device="cuda") -> DecodeState:
    """Zero caches and states for ``batch`` sequences of up to
    ``cache_len`` tokens; with an encoder-decoder model's ``enc_out`` and
    ``params``, the cross K/V too."""
    device = resolve_device(device)
    dtype = dtype or cfg.activation_dtype
    states = [B.block_state_init(cfg, bt, batch, cache_len, dtype, device)
              for bt in layer_types(cfg)]
    cross_kv = None
    if cfg.is_enc_dec and enc_out is not None and params is not None:
        cross_kv = precompute_cross_kv(params, enc_out, cfg)
    return DecodeState(block_states=states,
                       pos=torch.zeros((batch,), dtype=torch.int32,
                                       device=device),
                       cross_kv=cross_kv)


@torch.no_grad()
def decode_step(params: Model, state: DecodeState, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, DecodeState]:
    """tokens (B, 1) -> (logits (B, 1, V) fp32, new state).  A scanned
    layer of unit u decodes with unit u's cross K/V; the tail's layers, as
    the reference's, with none.  Plain PyTorch (the JAX package has no
    kernel on this path)."""
    x = embed_tokens(params, tokens, cfg)
    p = len(cfg.block_pattern)
    scanned = cfg.n_units * p
    new_states = []
    for j, (blk, st) in enumerate(zip(params.layers, state.block_states)):
        cross = None
        if state.cross_kv is not None and j < scanned:
            cross = state.cross_kv[j // p]
        x, ns = B.apply_block_decode(blk, x, st, state.pos, cfg,
                                     blk.block_type, cross_kv=cross)
        new_states.append(ns)
    logits = logits_from_hidden(params, x, cfg)
    return logits, state._replace(block_states=new_states,
                                  pos=state.pos + 1)
