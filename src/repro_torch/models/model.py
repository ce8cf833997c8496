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

``forward`` and ``encode`` run each scanned unit on the weights the unit
computes with: with ``bf16_weight_gather``, each fp32 tensor of two or more
dims cast to the activation dtype before the unit (the reference casts its
stacked unit leaves of three or more dims before the scan; norm scales and
biases stay fp32, the fp32 masters stay the parameters), and on a placed
model (``model.placement``, as ``launch.train.train`` makes it) the unit's
blocks gathered over the mesh, after that cast.  The root's tensors (embed,
head, the final norms) and the tail's are gathered uncast, as the reference
casts only its scanned units.
"""

from __future__ import annotations

import contextlib
import math
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

    def init_pieces(self):
        """``reset_parameters``' draws in their order: (the parameter names
        a draw fills, draw(generator)); the embed table, the head, then
        each norm, layer and encoder layer in turn."""
        def embed(g):
            with torch.no_grad():
                self.embed.normal_(generator=g).mul_(0.02)

        yield ["embed"], embed
        if not self.cfg.tie_embeddings:
            yield ["head"], lambda g: L._init(self.head, g)
        for name, m in self.named_children():
            items = (m.named_children() if isinstance(m, nn.ModuleList)
                     else [("", m)])
            for sub, blk in items:
                prefix = f"{name}.{sub}" if sub else name
                yield ([f"{prefix}.{k}" for k, _ in blk.named_parameters()],
                       blk.reset_parameters)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for _, draw in self.init_pieces():
            draw(generator)

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


def init_params_placed(cfg: ModelConfig, *, generator: torch.Generator,
                       placement_of, device="cuda") -> Model:
    """``init_params``' model, each parameter cut to this rank's block as
    soon as it is drawn: the model is built on the meta device, each piece
    (the embed table, the head, a norm, a layer) is made on ``device``,
    drawn from ``generator`` in ``init_params``' order (so the values are
    ``init_params``' bits) and replaced by its block, so no rank holds the
    whole fp32 state at once.  ``placement_of(model)`` gives the placement
    from the meta model; it is bound to the result."""
    dev = resolve_device(device)
    model = Model(cfg, "meta")
    pl = placement_of(model)
    for names, draw in model.init_pieces():
        for k in names:
            _set_param(model, k, torch.empty(
                pl.shapes[k], dtype=torch.float32, device=dev))
        draw(generator)
        if not pl.trivial:
            for k in names:
                _set_param(model, k,
                           pl.shard(k, model.get_parameter(k).data).clone())
    pl.bind(model)
    return model


def _set_param(model: nn.Module, name: str, value: torch.Tensor) -> None:
    owner, _, attr = name.rpartition(".")
    setattr(model.get_submodule(owner) if owner else model, attr,
            nn.Parameter(value))


def _cast_dtype(cfg: ModelConfig, p: torch.Tensor):
    """The dtype a scanned unit computes with ``p`` in, or None for its
    own: ``bf16_weight_gather`` casts fp32 tensors of two or more dims."""
    if (cfg.bf16_weight_gather and p.dtype == torch.float32
            and p.dim() >= 2 and cfg.activation_dtype != torch.float32):
        return cfg.activation_dtype
    return None


# the tensor-parallel sub-blocks: {sub-module: {parameter: the dim its spec
# must shard over ``model``}} (column-parallel products on dim 1 and their
# biases, the row-parallel product on dim 0)
_TP_SLICES = {"attn": {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0,
                       "bv": 0},
              "cross": {"wq": 1, "wk": 1, "wv": 1, "wo": 0},
              "mlp": {"wg": 1, "wu": 1, "bu": 0, "wd": 0}}
# whole tensors a tensor-parallel sub-block applies to its own heads only:
# each model rank's gradient is a partial sum
_TP_PARTIAL = {"attn": ("q_norm", "k_norm"), "cross": ("q_norm", "k_norm")}


def _tp_plan(block, cfg: ModelConfig, placement):
    """(the block's ``ModelParallel``, the parameters kept as their model
    slices, those whose gradient is a partial sum over ``model``), or None
    where the block runs whole on every model rank.  An attention block's
    attention (self and cross) runs on this rank's heads when the heads
    split evenly and the spec shards each product as Megatron's pair needs;
    its dense MLP on this rank's slice of d_ff likewise.  MoE, RG-LRU and
    the xLSTM blocks gather their tensors whole."""
    m = placement.sizes.get("model", 1)
    if m == 1 or getattr(block, "block_type", None) not in B.ATTN_BLOCKS:
        return None
    heads = cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
    tp = placement.model_parallel(cfg.with_overrides(
        n_heads=cfg.n_heads // m, n_kv_heads=cfg.n_kv_heads // m,
        d_head=cfg.head_dim))
    local, partial = set(), set()
    for sub, dims in _TP_SLICES.items():
        mod = getattr(block, sub, None)
        if mod is None or (sub != "mlp" and not heads):
            continue
        params = {k: p for k, p in mod._parameters.items() if p is not None}
        if not all(placement.shard_dims(placement.name_of(p)).get("model")
                   == dims[k] for k, p in params.items() if k in dims):
            continue
        setattr(tp, sub, True)
        local |= {id(p) for k, p in params.items() if k in dims}
        partial |= {id(params[k]) for k in _TP_PARTIAL.get(sub, ())
                    if k in params}
    if not (tp.attn or tp.cross or tp.mlp):
        return None
    return tp, local, partial


@contextlib.contextmanager
def computing_weights(modules, cfg: ModelConfig, placement, cast: bool):
    """Within the block, each parameter of ``modules`` (their own and
    their sub-modules') reads as the tensor the unit computes with: cast
    where ``cast`` and ``_cast_dtype`` say, and on a placed model gathered
    whole, or over ``data`` only where a tensor-parallel product takes its
    ``model`` slice (``_tp_plan``).  Differentiable back to the
    parameters.  Yields {id(module): its ``ModelParallel``} for the modules
    that run tensor-parallel."""
    slots = [(m, k, p) for mod in modules for m in mod.modules()
             for k, p in m._parameters.items() if p is not None]
    dtypes = [_cast_dtype(cfg, p) if cast else None for _, _, p in slots]
    plans = {}
    if placement is not None and not placement.trivial:
        local, partial = set(), set()
        for mod in modules:
            plan = _tp_plan(mod, cfg, placement)
            if plan is not None:
                plans[id(mod)] = plan[0]
                local |= plan[1]
                partial |= plan[2]
        params = [p for _, _, p in slots]
        new = placement.gather(params, dtypes,
                               local=[id(p) in local for p in params],
                               partial=[id(p) in partial for p in params])
    elif any(dt is not None for dt in dtypes):
        new = [p if dt is None else p.to(dt)
               for (_, _, p), dt in zip(slots, dtypes)]
    else:
        yield plans
        return
    for (m, k, _), t in zip(slots, new):
        m._parameters[k] = t
    try:
        yield plans
    finally:
        for m, k, p in slots:
            m._parameters[k] = p


def placement_summary(model: Model, opt) -> dict:
    """What a rank of a placed model holds and what its step gathers: the
    placed tensors, those sharded on this mesh, the blocks that run
    tensor-parallel and the tensors they read as model slices
    (``_tp_plan``), the tensors sharded over ``model`` that are gathered
    whole before their unit, the gather groups (a scanned unit each, the
    root, the tail, an encoder layer each), and the bytes of this rank's
    params, m and v."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    pl, cfg = model.placement, model.cfg
    sharded = [k for k in pl.specs if pl.shard_dims(k)]
    tp_blocks = sliced = 0
    for blk in list(model.layers) + list(getattr(model, "enc_layers", [])):
        plan = _tp_plan(blk, cfg, pl)
        if plan is not None:
            tp_blocks += 1
            sliced += len(plan[1])
    over_model = sum("model" in pl.shard_dims(k) for k in sharded)
    return {
        "mesh": dict(pl.sizes), "placed_tensors": len(pl.specs),
        "sharded_tensors": len(sharded),
        "tensor_parallel_blocks": tp_blocks,
        "model_sliced_tensors": sliced,
        "model_gathered_tensors": over_model - sliced,
        "gather_groups": cfg.n_units + 1
        + (len(cfg.tail_pattern) > 0) + cfg.encoder_layers,
        "param_bytes": nbytes(model.parameters()),
        "m_bytes": nbytes(opt.m.values()),
        "v_bytes": nbytes(opt.v.values()),
        "whole_param_bytes": sum(4 * math.prod(s)
                                 for s in pl.shapes.values())}


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
                enc_pos: Optional[torch.Tensor], force_ref: bool,
                placement=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pattern unit: (x, the unit's aux loss), on the weights the unit
    computes with (``computing_weights``: gathered and cast here, so a
    recompute in the backward gathers them again)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = L.constrain_batch(x, cfg)
    with computing_weights(blocks, cfg, placement, cast=True) as tps:
        for blk in blocks:
            x, a = B.apply_block_train(blk, x, cfg, blk.block_type,
                                       positions, causal=causal,
                                       enc_out=enc_out, enc_pos=enc_pos,
                                       force_ref=force_ref,
                                       tp=tps.get(id(blk)))
            x = L.constrain_batch(x, cfg)
            aux = aux + a
    return x, aux


def _apply_stack(layers, n_units: int, p: int, x: torch.Tensor,
                 cfg: ModelConfig,
                 positions: torch.Tensor, *, causal: bool,
                 enc_out: Optional[torch.Tensor] = None,
                 enc_pos: Optional[torch.Tensor] = None,
                 force_ref: bool = False, remat: bool = True,
                 placement=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's scan over ``n_units`` pattern units of ``p`` blocks,
    then the tail's blocks (without remat and uncast, as the reference
    applies them).  Under grad with ``remat`` each unit is recomputed in
    the backward (``torch.utils.checkpoint``), so only the units' inputs
    are kept."""
    rc = remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for u in range(n_units):
        args = (layers[u * p:(u + 1) * p], x, cfg, positions, causal,
                enc_out, enc_pos, force_ref, placement)
        x, a = (checkpoint(_apply_unit, *args, use_reentrant=False) if rc
                else _apply_unit(*args))
        aux = aux + a
    tail = layers[n_units * p:]
    with computing_weights(tail, cfg, placement, cast=False) as tps:
        for blk in tail:
            x, a = B.apply_block_train(blk, x, cfg, blk.block_type,
                                       positions, causal=causal,
                                       enc_out=enc_out, enc_pos=enc_pos,
                                       force_ref=force_ref,
                                       tp=tps.get(id(blk)))
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
                        cfg, pos, causal=False, remat=remat,
                        placement=getattr(params, "placement", None))
    with computing_weights([params.enc_final_norm], cfg,
                           getattr(params, "placement", None), cast=False):
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
    placement = getattr(params, "placement", None)
    root = _Root(params)
    with computing_weights([root], cfg, placement, cast=False):
        x = embed_tokens(params, tokens, cfg)
        enc_out = enc_pos = None
        if cfg.is_enc_dec:
            enc_out = encode(params, batch["frames"], cfg, remat=remat)
            enc_pos = _positions(b, enc_out.shape[1], tokens.device)
        x, aux = _apply_stack(params.layers, cfg.n_units,
                              len(cfg.block_pattern), x, cfg, positions,
                              causal=True, enc_out=enc_out, enc_pos=enc_pos,
                              force_ref=force_ref, remat=remat,
                              placement=placement)
        return logits_from_hidden(params, x, cfg), aux


class _Root:
    """The root's own tensors (embed, head) and its final norm, as one
    group for ``computing_weights``: ``modules()`` yields the model itself
    (for its ``_parameters``) and ``final_norm``."""

    def __init__(self, model: Model):
        self.model = model

    def modules(self):
        return [self.model, self.model.final_norm]


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
