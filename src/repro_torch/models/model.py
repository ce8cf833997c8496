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
casts only its scanned units.  ``decode_step`` on a placed model gathers
each unit's weights the same way (its dense MLPs tensor-parallel, its
attention whole) and reads a decode state placed by ``place_decode_state``:
each rank holds its rows of every leaf and, with ``shard_cache_seq``, its
slots of each KV cache, whose attention the ``model`` ranks merge
(``sharding.SeqShard``).  With ``sequence_parallel`` on a placed model
whose ``model`` axis is above 1, the residual stream of a train step holds
this rank's slice of the sequence between blocks (``sharding.SeqParallel``:
Megatron's all-gather / reduce-scatter pair in place of the
tensor-parallel copy / sum; blocks without tensor parallelism gather the
sequence and keep their slice), and ``forward`` returns that slice's
logits.

``abstract_params`` and ``abstract_decode_state`` build the model and the
decode state on the meta device (the dry run's): shapes and dtypes, no
storage.
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


def abstract_params(cfg: ModelConfig) -> Model:
    """The model on the meta device: every parameter's shape and dtype, no
    storage (the dry run's; ``init_params_placed`` fills a meta model)."""
    return Model(cfg, "meta")


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


def _tp_plan(block, cfg: ModelConfig, placement, subs=None, seq=None):
    """(the block's ``ModelParallel``, the parameters kept as their model
    slices, those whose gradient is a partial sum over ``model``), or None
    where the block runs whole on every model rank.  An attention block's
    attention (self and cross) runs on this rank's heads when the heads
    split evenly and the spec shards each product as Megatron's pair needs;
    its dense MLP on this rank's slice of d_ff likewise.  MoE, RG-LRU and
    the xLSTM blocks gather their tensors whole.  ``subs``: the sub-blocks
    that may run tensor-parallel (default all; decode takes the MLP only);
    ``seq``: the ``SeqParallel`` of a sequence-parallel step."""
    m = placement.sizes.get("model", 1)
    if m == 1 or getattr(block, "block_type", None) not in B.ATTN_BLOCKS:
        return None
    heads = cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
    tp = placement.model_parallel(cfg.with_overrides(
        n_heads=cfg.n_heads // m, n_kv_heads=cfg.n_kv_heads // m,
        d_head=cfg.head_dim), seq=seq)
    local, partial = set(), set()
    for sub, dims in _TP_SLICES.items():
        mod = getattr(block, sub, None)
        if mod is None or (sub != "mlp" and not heads) or (
                subs is not None and sub not in subs):
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
def computing_weights(modules, cfg: ModelConfig, placement, cast: bool, *,
                      tp_subs=None, seq=None):
    """Within the block, each parameter of ``modules`` (their own and
    their sub-modules') reads as the tensor the unit computes with: cast
    where ``cast`` and ``_cast_dtype`` say, and on a placed model gathered
    whole, or over ``data`` only where a tensor-parallel product takes its
    ``model`` slice (``_tp_plan``, restricted to the sub-blocks
    ``tp_subs``).  Differentiable back to the parameters: under ``seq`` (a
    sequence-parallel step) every tensor read whole computes on this
    rank's slice of the sequence, so its gradient is a partial sum over
    ``model``.  Yields {id(module): its ``ModelParallel``} for the modules
    that run tensor-parallel."""
    slots = [(m, k, p) for mod in modules for m in mod.modules()
             for k, p in m._parameters.items() if p is not None]
    dtypes = [_cast_dtype(cfg, p) if cast else None for _, _, p in slots]
    plans = {}
    if placement is not None and not placement.trivial:
        local, partial = set(), set()
        for mod in modules:
            plan = _tp_plan(mod, cfg, placement, tp_subs, seq)
            if plan is not None:
                plans[id(mod)] = plan[0]
                local |= plan[1]
                partial |= plan[2]
        params = [p for _, _, p in slots]
        if seq is not None:
            partial = {id(p) for p in params} - local
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
                placement=None, seq=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pattern unit: (x, the unit's aux loss), on the weights the unit
    computes with (``computing_weights``: gathered and cast here, so a
    recompute in the backward gathers them again)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = L.constrain_batch(x, cfg)
    with computing_weights(blocks, cfg, placement, cast=True,
                           seq=seq) as tps:
        for blk in blocks:
            x, a = B.apply_block_train(blk, x, cfg, blk.block_type,
                                       positions, causal=causal,
                                       enc_out=enc_out, enc_pos=enc_pos,
                                       force_ref=force_ref,
                                       tp=tps.get(id(blk)), sp=seq)
            x = L.constrain_batch(x, cfg)
            aux = aux + a
    return x, aux


def _apply_stack(layers, n_units: int, p: int, x: torch.Tensor,
                 cfg: ModelConfig,
                 positions: torch.Tensor, *, causal: bool,
                 enc_out: Optional[torch.Tensor] = None,
                 enc_pos: Optional[torch.Tensor] = None,
                 force_ref: bool = False, remat: bool = True,
                 placement=None, seq=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's scan over ``n_units`` pattern units of ``p`` blocks,
    then the tail's blocks (without remat and uncast, as the reference
    applies them).  Under grad with ``remat`` each unit is recomputed in
    the backward (``torch.utils.checkpoint``), so only the units' inputs
    are kept."""
    rc = remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for u in range(n_units):
        args = (layers[u * p:(u + 1) * p], x, cfg, positions, causal,
                enc_out, enc_pos, force_ref, placement, seq)
        x, a = (checkpoint(_apply_unit, *args, use_reentrant=False) if rc
                else _apply_unit(*args))
        aux = aux + a
    tail = layers[n_units * p:]
    with computing_weights(tail, cfg, placement, cast=False,
                           seq=seq) as tps:
        for blk in tail:
            x, a = B.apply_block_train(blk, x, cfg, blk.block_type,
                                       positions, causal=causal,
                                       enc_out=enc_out, enc_pos=enc_pos,
                                       force_ref=force_ref,
                                       tp=tps.get(id(blk)), sp=seq)
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


def seq_parallel(params: Model, cfg: ModelConfig):
    """The ``SeqParallel`` of a train step on ``params`` under ``cfg``, or
    None: ``sequence_parallel`` on a placed decoder-only model whose policy
    splits tensors over a ``model`` axis above 1 (``dp_only`` folds
    ``model`` into the batch, and an encoder-decoder model runs without
    it: the flag is a layout, and the step's result is the same)."""
    pl = getattr(params, "placement", None)
    if (not cfg.sequence_parallel or pl is None or cfg.is_enc_dec
            or pl.policy.model_size <= 1):
        return None
    return pl.seq_parallel()


def forward(params: Model, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            *, force_ref: bool = False, remat: bool = True,
            last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill / scoring / training forward.  batch: tokens (B, S) [+ frames
    (B, S_enc, d) for encoder-decoder models] on the model's device.
    Returns (logits (B, S, V) fp32, aux loss); under ``seq_parallel`` the
    logits of this rank's slice of S only (``SeqParallel.bounds``), and
    with ``last_only`` (a prefill's next token) those of the last position
    only, (B, 1, V).  ``force_ref`` runs the sLSTM layers' plain recurrence
    instead of the kernel; ``remat`` (under grad) recomputes each pattern
    unit in the backward."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    placement = getattr(params, "placement", None)
    seq = seq_parallel(params, cfg)
    root = _Root(params)
    with computing_weights([root], cfg, placement, cast=False, seq=seq):
        x = embed_tokens(params, tokens if seq is None
                         else seq.keep(tokens), cfg)
        enc_out = enc_pos = None
        if cfg.is_enc_dec:
            enc_out = encode(params, batch["frames"], cfg, remat=remat)
            enc_pos = _positions(b, enc_out.shape[1], tokens.device)
        x, aux = _apply_stack(params.layers, cfg.n_units,
                              len(cfg.block_pattern), x, cfg, positions,
                              causal=True, enc_out=enc_out, enc_pos=enc_pos,
                              force_ref=force_ref, remat=remat,
                              placement=placement, seq=seq)
        if last_only:
            x = x[:, -1:]
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
    # a placed state (``place_decode_state``): per decoder layer, the
    # number of ``model`` ranks its KV cache's slots are split over (1:
    # whole, or no cache)
    seq_shards: Optional[Tuple[int, ...]] = None


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
                      device="cuda", placement=None) -> DecodeState:
    """Zero caches and states for ``batch`` sequences of up to
    ``cache_len`` tokens; with an encoder-decoder model's ``enc_out`` and
    ``params``, the cross K/V too.  With ``placement`` (the served model's)
    only this rank's blocks are made, a layer at a time: the state
    ``place_decode_state`` would cut from the whole one, which is never
    held (encoder-decoder models: place a whole state instead)."""
    device = resolve_device(device)
    dtype = dtype or cfg.activation_dtype
    if placement is not None:
        if cfg.is_enc_dec:
            raise ValueError("an encoder-decoder state is placed whole: "
                             "place_decode_state")
        want = place_decode_state(abstract_decode_state(
            cfg, batch, cache_len), cfg, placement)
        states = []
        for bt, st in zip(layer_types(cfg), want.block_states):
            made = B.block_state_init(cfg, bt, st[0].shape[0], cache_len,
                                      dtype, device)
            states.append(type(made)(*(
                t if t.shape == w.shape else torch.zeros(
                    w.shape, dtype=t.dtype, device=device)
                for t, w in zip(made, st))))
            del made
        return want._replace(block_states=states, pos=torch.zeros(
            want.pos.shape, dtype=torch.int32, device=device))
    states = [B.block_state_init(cfg, bt, batch, cache_len, dtype, device)
              for bt in layer_types(cfg)]
    cross_kv = None
    if cfg.is_enc_dec and enc_out is not None and params is not None:
        cross_kv = precompute_cross_kv(params, enc_out, cfg)
    return DecodeState(block_states=states,
                       pos=torch.zeros((batch,), dtype=torch.int32,
                                       device=device),
                       cross_kv=cross_kv)


def abstract_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                          with_cross_len: int = 0) -> DecodeState:
    """The decode state on the meta device (the dry run's), with an
    encoder-decoder model's cross K/V of ``with_cross_len`` frames."""
    st = init_decode_state(cfg, batch, cache_len, device="meta")
    if with_cross_len:
        kv = torch.empty((batch, with_cross_len, cfg.n_kv_heads,
                          cfg.head_dim), dtype=cfg.activation_dtype,
                         device="meta")
        st = st._replace(cross_kv=[(kv, kv)] * cfg.n_units)
    return st


def decode_leaves(state: DecodeState, cfg: ModelConfig):
    """Each tensor of a decode state: (its address in the port's state,
    the path of the reference leaf that holds it, its index along the
    leaf's stacked unit dim or None, the tensor).  The reference stacks the
    units' states (``block_states/<i>/<field>``, or ``block_states/units/
    <i>/<field>`` beside ``block_states/tail/<i>/<field>`` where the model
    has a tail) and the cross K/V (``cross_kv/0``, ``cross_kv/1``)."""
    p = len(cfg.block_pattern)
    scanned = cfg.n_units * p
    tail = bool(cfg.tail_pattern)
    for j, st in enumerate(state.block_states):
        if j < scanned:
            head, u = ("units/" if tail else "") + str(j % p), j // p
        else:
            head, u = f"tail/{j - scanned}", None
        for field, t in zip(st._fields, st):
            yield (("block_states", j, field),
                   f"block_states/{head}/{field}", u, t)
    yield ("pos",), "pos", None, state.pos
    for u, kv in enumerate(state.cross_kv or ()):
        for i, t in enumerate(kv):
            yield ("cross_kv", u, i), f"cross_kv/{i}", u, t


def decode_state_shapes(state: DecodeState, cfg: ModelConfig
                        ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{reference leaf path: (its shape, dtype)}: the reference's decode
    state tree of this state (a stacked leaf's shape leads with its unit
    count)."""
    out: Dict[str, Any] = {}
    units: Dict[str, int] = {}
    for _, path, u, t in decode_leaves(state, cfg):
        if u is not None:
            units[path] = units.get(path, 0) + 1
        out[path] = (tuple(t.shape), t.dtype)
    return {k: ((units[k],) + shape if k in units else shape, dt)
            for k, (shape, dt) in out.items()}


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def decode_state_specs(state: DecodeState, cfg: ModelConfig, policy
                       ) -> Dict[tuple, Tuple[Any, ...]]:
    """{port address: spec} of each tensor of a (whole) decode state: the
    spec ``policy.serve_state_spec`` gives its reference leaf (through
    ``serve_spec_tree``), less the unit dim of a stacked leaf."""
    shapes = decode_state_shapes(state, cfg)
    specs = policy.serve_spec_tree(_nest({k: v[0]
                                          for k, v in shapes.items()}))
    out = {}
    for key, path, u, _ in decode_leaves(state, cfg):
        spec = specs
        for k in path.split("/"):
            spec = spec[k]
        out[key] = tuple(spec[1:] if u is not None else spec)
    return out


def place_decode_state(state: DecodeState, cfg: ModelConfig,
                       placement) -> DecodeState:
    """This rank's block of a whole decode state, placed by the policy of
    ``placement`` (the served model's): each tensor's rows over the batch
    axes where they divide the batch and, with ``shard_cache_seq``, each KV
    cache's slots over ``model`` (``decode_state_specs``).  The result
    records each layer's split of its cache (``seq_shards``)."""
    specs = decode_state_specs(state, cfg, placement.policy)
    sizes, coord = placement.sizes, placement._coord()

    def block(key, t):
        for dim, ax in enumerate(specs[key]):
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None and sizes[a] > 1:
                    n = t.shape[dim] // sizes[a]
                    t = t.narrow(dim, coord[a] * n, n)
        return t.clone()

    layers = []
    shards = []
    for j, st in enumerate(state.block_states):
        layers.append(type(st)(*(block(("block_states", j, f), t)
                                 for f, t in zip(st._fields, st))))
        spec = specs.get(("block_states", j, "k"), ())
        shards.append(sizes["model"] if len(spec) > 1 and
                      spec[1] == "model" and sizes.get("model", 1) > 1
                      else 1)
    cross = None if state.cross_kv is None else [
        tuple(block(("cross_kv", u, i), t) for i, t in enumerate(kv))
        for u, kv in enumerate(state.cross_kv)]
    return DecodeState(block_states=layers, pos=block(("pos",), state.pos),
                       cross_kv=cross, seq_shards=tuple(shards))


@torch.no_grad()
def decode_step(params: Model, state: DecodeState, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, DecodeState]:
    """tokens (B, 1) -> (logits (B, 1, V) fp32, new state).  A scanned
    layer of unit u decodes with unit u's cross K/V; the tail's layers, as
    the reference's, with none.  Plain PyTorch (the JAX package has no
    kernel on this path).

    On a placed model each unit's weights are gathered before it runs, as
    ``forward`` gathers them (cast by ``bf16_weight_gather``), its dense
    MLPs on this rank's slice of d_ff (``ModelParallel``) and its attention
    on the whole projections; ``state`` then holds this rank's rows (and,
    where ``seq_shards`` splits a cache, its slots: the ``model`` ranks'
    partial softmax sums are merged, ``sharding.SeqShard``)."""
    placement = getattr(params, "placement", None)
    if placement is None:
        return _decode_layers(params, state, tokens, cfg, None)
    with computing_weights([_Root(params)], cfg, placement, cast=False):
        return _decode_layers(params, state, tokens, cfg, placement)


def _decode_layers(params: Model, state: DecodeState, tokens: torch.Tensor,
                   cfg: ModelConfig, placement
                   ) -> Tuple[torch.Tensor, DecodeState]:
    x = embed_tokens(params, tokens, cfg)
    p = len(cfg.block_pattern)
    scanned = cfg.n_units * p
    shards = state.seq_shards or (1,) * len(params.layers)
    new_states = []
    groups = [list(range(u * p, (u + 1) * p)) for u in range(cfg.n_units)]
    groups += [[j] for j in range(scanned, len(params.layers))]
    for idx in groups:
        blocks = [params.layers[j] for j in idx]
        ctx = (computing_weights(blocks, cfg, placement,
                                 cast=idx[0] < scanned, tp_subs=("mlp",))
               if placement is not None else contextlib.nullcontext({}))
        with ctx as tps:
            for j, blk in zip(idx, blocks):
                cross = None
                if state.cross_kv is not None and j < scanned:
                    cross = state.cross_kv[j // p]
                seq = (placement.seq_shard() if shards[j] > 1 else None)
                x, ns = B.apply_block_decode(
                    blk, x, state.block_states[j], state.pos, cfg,
                    blk.block_type, cross_kv=cross, tp=tps.get(id(blk)),
                    seq=seq)
                new_states.append(ns)
    logits = logits_from_hidden(params, x, cfg)
    return logits, state._replace(block_states=new_states,
                                  pos=state.pos + 1)
