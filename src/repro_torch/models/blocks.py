"""Block-level init/apply dispatch for every block type, train (full
sequence) and decode paths: the port of the JAX package's
``repro.models.blocks``.

Each block is pre-norm residual: attention (full, sliding window, local)
with an MLP or MoE, RG-LRU with an MLP, or the self-contained xLSTM blocks
(their FFN / gating is internal).  Decoder blocks of an encoder-decoder
model add a cross-attention sub-block (``cross_norm``, ``cross``).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch import nn

from . import layers as L
from . import recurrent as R
from .config import ModelConfig

ATTN_BLOCKS = ("attn", "swa", "local_attn", "attn_moe", "swa_moe")
BLOCK_TYPES = ATTN_BLOCKS + ("rglru", "mlstm", "slstm")


def block_window(cfg: ModelConfig, block_type: str) -> int:
    if block_type.startswith("swa"):
        return cfg.window
    if block_type == "local_attn":
        return cfg.local_window
    return 0


class Block(nn.Module):
    """One pre-norm residual block; its sub-modules carry the reference's
    dict keys (``norm1``, ``attn``, ``norm2``, ``mlp`` / ``moe``, ``rglru``,
    ``mlstm``, ``slstm``, ``cross_norm``, ``cross``)."""

    def __init__(self, cfg: ModelConfig, block_type: str, device,
                 with_cross: bool = False):
        super().__init__()
        if block_type not in BLOCK_TYPES:
            raise ValueError(block_type)
        self.block_type = block_type
        self.norm1 = L.init_norm(cfg, device)
        if block_type in ATTN_BLOCKS:
            self.attn = L.Attention(cfg, device)
            self.norm2 = L.init_norm(cfg, device)
            if block_type.endswith("moe"):
                self.moe = L.MoE(cfg, device)
            else:
                self.mlp = L.MLP(cfg, device)
        elif block_type == "rglru":
            self.rglru = R.RGLRU(cfg, device)
            self.norm2 = L.init_norm(cfg, device)
            self.mlp = L.MLP(cfg, device)
        elif block_type == "mlstm":
            self.mlstm = R.MLSTM(cfg, device)
        else:
            self.slstm = R.SLSTM(cfg, device)
        if with_cross:
            self.cross_norm = L.init_norm(cfg, device)
            self.cross = L.Attention(cfg, device, cross=True)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.children():
            m.reset_parameters(generator)


def init_block(cfg: ModelConfig, block_type: str, device,
               with_cross: bool = False) -> Block:
    """The block's parameters, uninitialised: ``reset_parameters`` fills
    them (``model.init_params``), or a converter loads them."""
    return Block(cfg, block_type, device, with_cross)


# ---------------------------------------------------------------------------
# train (full sequence)
# ---------------------------------------------------------------------------

def apply_block_train(p: Block, x: torch.Tensor, cfg: ModelConfig,
                      block_type: str, positions: torch.Tensor, *,
                      causal: bool = True,
                      enc_out: Optional[torch.Tensor] = None,
                      enc_pos: Optional[torch.Tensor] = None,
                      force_ref: bool = False, tp=None, sp=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux loss); only the MoE blocks have an aux loss.
    ``force_ref`` runs an sLSTM layer's plain recurrence.  ``tp``: the
    block's ``ModelParallel`` on a placed model, whose ``attn`` / ``cross``
    / ``mlp`` sub-blocks then run on this rank's heads or d_ff slice (their
    parameters read as those slices), summed over ``model``.  ``sp``: the
    step's ``SeqParallel``, where ``x`` is this rank's slice of the
    sequence: a tensor-parallel sub-block gathers and reduce-scatters the
    sequence (``tp`` carries the pair), any other sub-block runs on the
    gathered sequence and keeps its slice; norms and residual adds run on
    the slice.  ``positions`` are the whole sequence's."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.apply_norm(p.norm1, x, cfg)
    if block_type in ATTN_BLOCKS:
        window = block_window(cfg, block_type)
        if tp is not None and tp.attn:
            x = x + tp.reduce(L.attention_full(
                p.attn, tp.copy(h), tp.cfg, positions, causal=causal,
                window=window))
        else:
            x = x + _whole_seq(sp, lambda t: L.attention_full(
                p.attn, t, cfg, positions, causal=causal, window=window), h)
        if hasattr(p, "cross") and enc_out is not None:
            h = L.apply_norm(p.cross_norm, x, cfg)
            if tp is not None and tp.cross:
                kv = _cross_kv(p.cross, tp.copy(enc_out), tp.cfg, enc_pos)
                x = x + tp.reduce(L.attention_full(
                    p.cross, tp.copy(h), tp.cfg, positions, causal=False,
                    window=0, kv_override=kv))
            else:
                kv = _cross_kv(p.cross, enc_out, cfg, enc_pos)
                x = x + L.attention_full(p.cross, h, cfg, positions,
                                         causal=False, window=0,
                                         kv_override=kv)
        h = L.apply_norm(p.norm2, x, cfg)
        if block_type.endswith("moe"):
            delta, aux = _whole_seq(sp, lambda t: L.apply_moe(p.moe, t, cfg),
                                    h)
            return x + delta, aux
        if tp is not None and tp.mlp:
            return x + L.apply_mlp(p.mlp, h, cfg, tp=tp), aux
        return x + _whole_seq(sp, lambda t: L.apply_mlp(p.mlp, t, cfg),
                              h), aux
    if block_type == "rglru":
        x = x + _whole_seq(sp, lambda t: R.apply_rglru(p.rglru, t, cfg), h)
        h = L.apply_norm(p.norm2, x, cfg)
        return x + _whole_seq(sp, lambda t: L.apply_mlp(p.mlp, t, cfg),
                              h), aux
    if block_type == "mlstm":
        return x + _whole_seq(sp, lambda t: R.apply_mlstm(p.mlstm, t, cfg),
                              h), aux
    return x + _whole_seq(sp, lambda t: R.apply_slstm(
        p.slstm, t, cfg, force_ref=force_ref), h), aux


def _whole_seq(sp, fn, h: torch.Tensor):
    """``fn(h)``; under sequence parallelism (``sp``) ``fn`` of the whole
    sequence (``h`` gathered over ``model``) and this rank's slice of its
    output (the first of a tuple's)."""
    if sp is None:
        return fn(h)
    out = fn(sp.gather(h))
    if isinstance(out, tuple):
        return (sp.keep(out[0]),) + tuple(out[1:])
    return sp.keep(out)


def _cross_kv(p_attn: L.Attention, enc_out: torch.Tensor, cfg: ModelConfig,
              enc_pos: Optional[torch.Tensor]):
    """K/V projections of the encoder output for cross-attention (no bias,
    no k norm, no RoPE), with their positions."""
    b, t, _ = enc_out.shape
    dt = enc_out.dtype
    nkv, dh = cfg.n_kv_heads, cfg.head_dim
    k = (enc_out @ p_attn.wk.to(dt)).reshape(b, t, nkv, dh)
    v = (enc_out @ p_attn.wv.to(dt)).reshape(b, t, nkv, dh)
    if enc_pos is None:
        enc_pos = torch.arange(t, dtype=torch.int32,
                               device=enc_out.device)[None].expand(b, t)
    return k, v, enc_pos


# ---------------------------------------------------------------------------
# decode state
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor     # (B, S_cache, nkv, dh)
    v: torch.Tensor


def block_state_init(cfg: ModelConfig, block_type: str, batch: int,
                     cache_len: int, dtype: torch.dtype, device) -> Any:
    """The block's decode state: a KV cache of min(cache_len, window) slots
    where the block has a window (else cache_len), or the recurrent state
    (which ignores cache_len)."""
    if block_type in ATTN_BLOCKS:
        w = block_window(cfg, block_type)
        s = min(cache_len, w) if w > 0 else cache_len
        z = torch.zeros((batch, s, cfg.n_kv_heads, cfg.head_dim),
                        dtype=dtype, device=device)
        return KVCache(k=z, v=z)
    if block_type == "rglru":
        return R.rglru_init_state(cfg, batch, dtype, device)
    if block_type == "mlstm":
        return R.mlstm_init_state(cfg, batch, dtype, device)
    if block_type == "slstm":
        return R.slstm_init_state(cfg, batch, device)
    raise ValueError(block_type)


def apply_block_decode(p: Block, x_t: torch.Tensor, state: Any,
                       pos: torch.Tensor, cfg: ModelConfig, block_type: str,
                       cross_kv: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                       tp=None, seq=None) -> Tuple[torch.Tensor, Any]:
    """x_t (B, 1, d); pos (B,). Returns (x_t, new_state).  A windowed
    block whose cache holds no more than its window uses it as a ring.
    ``tp``: the block's ``ModelParallel`` on a placed model (its dense MLP
    on this rank's slice of d_ff); ``seq``: the ``SeqShard`` of a cache
    whose slots are split over ``model``."""
    h = L.apply_norm(p.norm1, x_t, cfg)
    if block_type in ATTN_BLOCKS:
        w = block_window(cfg, block_type)
        n_seq = 1 if seq is None else seq.n
        ring = w > 0 and state.k.shape[1] * n_seq <= w
        attn, ck, cv = L.attention_decode(p.attn, h, state.k, state.v, pos,
                                          cfg, window=w, ring=ring, seq=seq)
        x_t = x_t + attn
        if hasattr(p, "cross") and cross_kv is not None:
            h = L.apply_norm(p.cross_norm, x_t, cfg)
            x_t = x_t + _cross_decode(p.cross, h, cross_kv, cfg)
        h = L.apply_norm(p.norm2, x_t, cfg)
        if block_type.endswith("moe"):
            delta, _ = L.apply_moe(p.moe, h, cfg)
        else:
            delta = L.apply_mlp(p.mlp, h, cfg,
                                tp=tp if tp is not None and tp.mlp else None)
        return x_t + delta, KVCache(k=ck, v=cv)
    if block_type == "rglru":
        delta, new_r = R.apply_rglru_decode(p.rglru, h[:, 0], state, cfg)
        x_t = x_t + delta[:, None, :]
        h = L.apply_norm(p.norm2, x_t, cfg)
        return x_t + L.apply_mlp(p.mlp, h, cfg), new_r
    if block_type == "mlstm":
        delta, new_s = R.apply_mlstm_decode(p.mlstm, h[:, 0], state, cfg)
    else:
        delta, new_s = R.apply_slstm_decode(p.slstm, h[:, 0], state, cfg)
    return x_t + delta[:, None, :], new_s


def _cross_decode(p_cross: L.Attention, x_t: torch.Tensor,
                  cross_kv: Tuple[torch.Tensor, torch.Tensor],
                  cfg: ModelConfig) -> torch.Tensor:
    """Single-step cross-attention against precomputed encoder K/V: the q
    norm but no RoPE (``forward``'s cross-attention rotates q: a property
    of the reference, kept)."""
    b = x_t.shape[0]
    nq, nkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x_t.dtype
    k, v = cross_kv
    q = (x_t @ p_cross.wq.to(dt)).reshape(b, 1, nkv, nq // nkv, dh)
    if hasattr(p_cross, "q_norm"):
        q = L._qk_norm(q, p_cross.q_norm)
    sc = L._scores(q, k.to(dt))
    wts = torch.softmax(sc, dim=-1).to(dt)
    out = torch.einsum("bngst,btnh->bsngh", wts, v.to(dt))
    return out.reshape(b, 1, nq * dh) @ p_cross.wo.to(dt)
