"""Shared layers of the port's models: norms, RoPE, GQA attention (dense /
chunked online softmax / per-chunk extents / decode), MLPs and
grouped-capacity MoE — the port of the JAX package's
``repro.models.layers``.

Precision policy, as the reference: params fp32, compute in ``cfg.dtype``
(bf16 by default), norms, RoPE angles, attention scores, softmax and router
probabilities in fp32.  The reference computes all of this in plain ``jnp``
(no Pallas kernel), and the port in plain PyTorch.  Attention scores come
from fp32 copies of q and k: a bf16 ``torch.matmul`` would round them to
bf16, where the reference keeps them fp32 (``preferred_element_type``); the
softmax weights go back to the activation dtype before the PV product, as
the reference's do.

Modules hold the parameters under the reference's dict keys
(``models/convert.py`` relies on it); the math is in plain functions of
(module, tensors), cast for cast as in the reference.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig

NEG_INF = -1e30   # not -inf: a wholly masked kv chunk must stay finite


def _init(t: torch.Tensor, generator: torch.Generator,
          scale=None) -> torch.Tensor:
    """Fill t in place with scale × a standard normal truncated to [-2, 2];
    scale defaults to 1/sqrt(t.shape[0]) (``repro.models.layers._init``:
    the leading dim, so a stacked (E, d, f) expert tensor gets 1/sqrt(E))."""
    scale = scale if scale is not None else 1.0 / (t.shape[0] ** 0.5)
    with torch.no_grad():
        nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=generator)
        return t.mul_(scale)


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


def constrain_batch(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The JAX package pins the batch dim to mesh axes here; the port runs
    on one device, so this is the identity."""
    return x


def _act(cfg: ModelConfig):
    """The gated MLP's activation; ``jax.nn.gelu`` is the tanh form."""
    if cfg.mlp_type == "swiglu":
        return F.silu
    return lambda t: F.gelu(t, approximate="tanh")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rot_dims(cfg: ModelConfig) -> int:
    return int(cfg.head_dim * cfg.rope_pct) // 2 * 2


def rope_frequencies(cfg: ModelConfig, device=None) -> torch.Tensor:
    rot = _rot_dims(cfg)
    return 1.0 / (cfg.rope_theta ** (torch.arange(
        0, rot, 2, dtype=torch.float32, device=device) / rot))   # (rot/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, H, dh); positions (B, S) int.  Rotates the interleaved pairs
    (x[..., 0::2], x[..., 1::2]) of the first ``rot`` dims in fp32 and
    leaves the rest."""
    rot = _rot_dims(cfg)
    if rot == 0:
        return x
    inv = rope_frequencies(cfg, x.device)
    ang = positions.float()[..., None] * inv                 # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp.to(out.dtype)], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """``wq`` (d, nq·dh), ``wk`` / ``wv`` (d, nkv·dh), ``wo`` (nq·dh, d);
    ``bq`` / ``bk`` / ``bv`` when ``qkv_bias`` (never on cross-attention);
    ``q_norm`` / ``k_norm`` (dh,) when ``qk_norm``."""

    def __init__(self, cfg: ModelConfig, device, cross: bool = False):
        super().__init__()
        d, dh = cfg.d_model, cfg.head_dim
        nq, nkv = cfg.n_heads, cfg.n_kv_heads
        self.wq = _param((d, nq * dh), device)
        self.wk = _param((d, nkv * dh), device)
        self.wv = _param((d, nkv * dh), device)
        self.wo = _param((nq * dh, d), device)
        if cfg.qkv_bias and not cross:
            self.bq = _param((nq * dh,), device)
            self.bk = _param((nkv * dh,), device)
            self.bv = _param((nkv * dh,), device)
        if cfg.qk_norm:
            self.q_norm = _param((dh,), device)
            self.k_norm = _param((dh,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            _init(w, generator)
        with torch.no_grad():
            for name in ("bq", "bk", "bv"):
                if hasattr(self, name):
                    getattr(self, name).zero_()
            for name in ("q_norm", "k_norm"):
                if hasattr(self, name):
                    getattr(self, name).fill_(1.0)


def _qk_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale).to(x.dtype)


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 positions: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    dh, nq, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype
    q = x @ p.wq.to(dt)
    k = x @ p.wk.to(dt)
    v = x @ p.wv.to(dt)
    if hasattr(p, "bq"):
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    q = q.reshape(b, s, nq, dh)
    k = k.reshape(b, s, nkv, dh)
    v = v.reshape(b, s, nkv, dh)
    if hasattr(p, "q_norm"):
        q = _qk_norm(q, p.q_norm)
        k = _qk_norm(k, p.k_norm)
    if positions is not None:
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)
    return q, k, v


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(..., S, T) additive fp32 mask from absolute positions."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        ok &= diff >= 0
    if window > 0:
        ok &= diff < window
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,S,nkv,g,dh), k (B,T,nkv,dh) -> fp32 (B,nkv,g,S,T) / sqrt(dh):
    the products of the (bf16) inputs, exact in fp32, summed in fp32."""
    dh = q.shape[-1]
    sc = torch.einsum("bsngh,btnh->bngst", q.float(), k.float())
    return sc / (dh ** 0.5)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          bias: torch.Tensor) -> torch.Tensor:
    """q (B,S,nkv,g,dh), k/v (B,T,nkv,dh), bias (B,S,T) -> (B,S,nkv,g,dh)
    in q's dtype."""
    sc = _scores(q, k) + bias[:, None, None, :, :]
    w = torch.softmax(sc, dim=-1).to(q.dtype)
    return torch.einsum("bngst,btnh->bsngh", w, v.to(q.dtype))


def attention_route(cfg: ModelConfig, s: int, t: int, causal: bool,
                    chunk: int) -> str:
    """The reference's choice among its three full-sequence schedules."""
    if s <= cfg.dense_attn_threshold or s != t or s % chunk != 0:
        return "dense"
    if cfg.attn_schedule == "extent" and causal and s // chunk <= 16:
        return "extent"
    return "chunked"


def attention_full(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, *, causal: bool = True,
                   window: int = 0,
                   kv_override: Optional[Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]] = None,
                   chunk_q: Optional[int] = None) -> torch.Tensor:
    """Full-sequence attention: dense for short sequences, else chunked
    online softmax (fixed memory) or, with ``attn_schedule="extent"``, the
    per-q-chunk kv extents.  kv_override: (k, v, k_positions) for
    cross-attention."""
    b, s, _ = x.shape
    nq, nkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = nq // nkv
    chunk_q = chunk_q or cfg.attn_chunk
    q, k, v = _project_qkv(p, x, cfg, positions)
    k_pos = positions
    if kv_override is not None:
        k, v, k_pos = kv_override
    qg = q.reshape(b, s, nkv, g, dh)
    route = attention_route(cfg, s, k.shape[1], causal, chunk_q)
    if route == "dense":
        out = _sdpa(qg, k, v, _mask_bias(positions, k_pos, causal, window))
    elif route == "extent":
        out = _extent_attention(qg, k, v, positions, k_pos, window, chunk_q)
    else:
        out = _chunked_attention(qg, k, v, positions, k_pos, causal, window,
                                 chunk_q)
    out = out.to(x.dtype).reshape(b, s, nq * dh)
    return out @ p.wo.to(x.dtype)


def _online_softmax(q_blk, qp, kv_blocks, causal, window):
    """One q chunk (B,c,nkv,g,dh) against kv chunks [(k, v, k_pos)]: the
    running max / sum / fp32 accumulator of the reference's kv scan;
    the PV product in the activation dtype, as the reference's.  Returns
    (B,c,nkv,g,dh) fp32."""
    b, c, nkv, g, dh = q_blk.shape
    f32 = dict(dtype=torch.float32, device=q_blk.device)
    m = torch.full((b, nkv, g, c), NEG_INF, **f32)
    l = torch.zeros((b, nkv, g, c), **f32)
    acc = torch.zeros((b, nkv, g, c, dh), **f32)
    for k_blk, v_blk, kp in kv_blocks:
        bias = _mask_bias(qp, kp, causal, window)            # (B,c,c)
        sc = _scores(q_blk, k_blk) + bias[:, None, None, :, :]
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(sc - m_new[..., None])
        l = l * alpha + pexp.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bngst,btnh->bngsh", pexp.to(v_blk.dtype), v_blk)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4)                        # (B,c,nkv,g,dh)


def _kv_chunks(k, v, k_pos, lo, hi, chunk):
    return [(k[:, j: j + chunk], v[:, j: j + chunk], k_pos[:, j: j + chunk])
            for j in range(lo, hi, chunk)]


def _chunked_attention(qg, k, v, q_pos, k_pos, causal, window, chunk):
    """The "masked" schedule: every (q chunk, kv chunk) pair is computed and
    masked, online softmax over the kv chunks."""
    s, t = qg.shape[1], k.shape[1]
    assert s % chunk == 0 and t % chunk == 0, (s, t, chunk)
    kv = _kv_chunks(k, v, k_pos, 0, t, chunk)
    outs = [_online_softmax(qg[:, i: i + chunk], q_pos[:, i: i + chunk], kv,
                            causal, window)
            for i in range(0, s, chunk)]
    return torch.cat(outs, dim=1)


def _extent_attention(qg, k, v, q_pos, k_pos, window, chunk):
    """Causal chunked attention with static per-q-chunk kv extents: q chunk
    i attends kv in [lo_i, (i+1)·c), lo_i = max(0, i·c − w + 1) rounded
    down to a chunk; wholly masked chunks are never computed."""
    s = qg.shape[1]
    outs = []
    for qi in range(s // chunk):
        lo = 0
        if window > 0:
            lo = max(0, (qi * chunk - window + 1)) // chunk * chunk
        hi = (qi + 1) * chunk
        outs.append(_online_softmax(
            qg[:, qi * chunk: hi], q_pos[:, qi * chunk: hi],
            _kv_chunks(k, v, k_pos, lo, hi, chunk), True, window))
    return torch.cat(outs, dim=1)


def _cache_write(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor,
                 uniform: bool) -> torch.Tensor:
    """cache (B, S, nkv, dh) with row b's slot[b] replaced by new[b] (a new
    tensor, as the reference's functional update).  Ragged: a slot past the
    end writes nothing (the reference's scatter drops it).  Uniform: every
    row writes slot[0], clamped into [0, S-1] (the reference's
    ``dynamic_update_slice`` clamps its start)."""
    b, s_cache = cache.shape[:2]
    if uniform:
        slot = torch.clamp(slot[:1], 0, s_cache - 1).expand(b)
    hit = torch.arange(s_cache, device=cache.device)[None, :] == slot[:, None]
    return torch.where(hit[:, :, None, None], new[:, None].to(cache.dtype),
                       cache)


def attention_decode(p: Attention, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     cfg: ModelConfig, *, window: int = 0, ring: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode with a KV cache.  x (B, 1, d); cache_k/v (B,
    S_cache, nkv, dh); pos (B,) int the current positions.  ``ring=True``
    uses the cache as a circular window buffer (slot pos % S_cache).
    Returns (out (B, 1, d), new cache_k, new cache_v)."""
    b = x.shape[0]
    nq, nkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = nq // nkv
    s_cache = cache_k.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None])
    slot = torch.remainder(pos, s_cache) if ring else pos
    uniform = cfg.decode_pos_mode == "uniform"
    cache_k = _cache_write(cache_k, k_new[:, 0], slot, uniform)
    cache_v = _cache_write(cache_v, v_new[:, 0], slot, uniform)

    idx = torch.arange(s_cache, device=x.device)[None, :]
    pcol = pos[:, None].long()
    if ring:
        # slot i holds absolute position pos - ((pos - i) mod S); valid if
        # >= 0 (a floor mod, as jnp's %)
        k_positions = pcol - torch.remainder(pcol - idx, s_cache)
        valid = k_positions >= 0
        if window > 0:
            valid &= (pcol - k_positions) < window
    else:
        valid = idx <= pcol
        if window > 0:
            valid &= (pcol - idx) < window

    qg = q.reshape(b, 1, nkv, g, dh)
    sc = _scores(qg, cache_k.to(q.dtype))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    sc = sc + torch.where(valid, zero, torch.full_like(zero, NEG_INF))[
        :, None, None, None, :]
    w = torch.softmax(sc, dim=-1).to(q.dtype)
    out = torch.einsum("bngst,btnh->bsngh", w, cache_v.to(q.dtype))
    out = out.reshape(b, 1, nq * dh) @ p.wo.to(x.dtype)
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """swiglu / geglu: ``wg``, ``wu`` (d, f), ``wd`` (f, d); gelu: ``wu``,
    ``bu``, ``wd``, ``bd``."""

    def __init__(self, cfg: ModelConfig, device, d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        if cfg.mlp_type in ("swiglu", "geglu"):
            self.wg = _param((d, f), device)
            self.wu = _param((d, f), device)
            self.wd = _param((f, d), device)
        else:
            self.wu = _param((d, f), device)
            self.bu = _param((f,), device)
            self.wd = _param((f, d), device)
            self.bd = _param((d,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("wg", "wu", "wd"):
            if hasattr(self, name):
                _init(getattr(self, name), generator)
        with torch.no_grad():
            for name in ("bu", "bd"):
                if hasattr(self, name):
                    getattr(self, name).zero_()


def apply_mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig,
              tp=None) -> torch.Tensor:
    """``tp`` (a ``ModelParallel``): ``wg`` / ``wu`` / ``bu`` / ``wd`` read
    as this rank's slice of d_ff; the down product's partial sums are
    summed over ``model`` before ``bd``."""
    dt = x.dtype
    if tp is not None:
        x = tp.copy(x)
    if cfg.mlp_type in ("swiglu", "geglu"):
        h = _act(cfg)(x @ p.wg.to(dt)) * (x @ p.wu.to(dt))
        out = h @ p.wd.to(dt)
        return out if tp is None else tp.reduce(out)
    h = F.gelu(x @ p.wu.to(dt) + p.bu.to(dt), approximate="tanh")
    out = h @ p.wd.to(dt)
    if tp is not None:
        out = tp.reduce(out)
    return out + p.bd.to(dt)


# ---------------------------------------------------------------------------
# MoE (GShard-style grouped capacity routing)
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """``router`` (d, E); the experts stacked: ``wg`` / ``wu`` (E, d, f),
    ``wd`` (E, f, d) (gelu: ``wu`` and ``wd`` only, no biases)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
        self.router = _param((d, e), device)
        if cfg.mlp_type in ("swiglu", "geglu"):
            self.wg = _param((e, d, f), device)
        self.wu = _param((e, d, f), device)
        self.wd = _param((e, f, d), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _init(self.router, generator, scale=0.02)
        for name in ("wg", "wu", "wd"):
            if hasattr(self, name):
                _init(getattr(self, name), generator)


def moe_capacity(cfg: ModelConfig, group: int) -> int:
    cap = int(group * cfg.moe_top_k * cfg.moe_capacity_factor
              / cfg.moe_experts)
    return max(cap, cfg.moe_top_k)


def top_k_lowest_index(x: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, equal values in index order (as
    ``lax.top_k``; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _experts(p: MoE, xin: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Batched expert FFN: (B, E, C, d) -> (B, E, C, d)."""
    dt = xin.dtype
    if cfg.mlp_type in ("swiglu", "geglu"):
        h = _act(cfg)(torch.einsum("becd,edf->becf", xin, p.wg.to(dt))) * \
            torch.einsum("becd,edf->becf", xin, p.wu.to(dt))
    else:
        h = F.gelu(torch.einsum("becd,edf->becf", xin, p.wu.to(dt)),
                   approximate="tanh")
    return torch.einsum("becf,efd->becd", h, p.wd.to(dt))


def _route_groups(p: MoE, xg: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One wave: xg (B, g, d), a routing group per batch row, capacity
    C = moe_capacity(g).  Returns (y (B, g, d), aux (B,))."""
    b, g, d = xg.shape
    e, topk = cfg.moe_experts, cfg.moe_top_k
    cap = moe_capacity(cfg, g)
    dt = xg.dtype
    dev = xg.device
    logits = (xg @ p.router.to(dt)).float()                  # (B, g, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k_lowest_index(probs, topk)           # (B, g, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    sel = F.one_hot(top_e, e).float()                        # (B, g, k, E)
    sel_any = sel.sum(2)                                     # (B, g, E)
    # each token's place in its expert's queue, k slot 0 first, then token
    # order (0-based)
    pos = torch.cumsum(sel.reshape(b, g * topk, e), dim=1).reshape(
        b, g, topk, e) - sel
    keep = (pos < cap).float() * sel                         # (B, g, k, E)
    pos_idx = torch.clamp(pos, max=cap - 1).long()

    if cfg.moe_dispatch == "gather":
        # slot = expert * cap + place for each kept (token, k); the dump
        # slot e * cap takes the dropped ones
        slot_ek = top_e * cap + (pos_idx * sel.long()).sum(-1)   # (B, g, k)
        kept = keep.sum(-1) > 0
        flat_slot = torch.where(kept, slot_ek, e * cap)
        tok_ids = torch.arange(g, device=dev)[None, :, None].expand(
            b, g, topk)
        buf_tok = torch.full((b, e * cap + 1), g, dtype=torch.long,
                             device=dev)                     # g: a zero row
        buf_tok.scatter_(1, flat_slot.reshape(b, -1), tok_ids.reshape(b, -1))
        xg_pad = torch.cat([xg, xg.new_zeros((b, 1, d))], dim=1)
        bidx = torch.arange(b, device=dev)[:, None]
        xin = xg_pad[bidx, buf_tok[:, : e * cap]].reshape(b, e, cap, d)
        hout = _experts(p, xin, cfg)
        h_pad = torch.cat([hout.reshape(b, e * cap, d),
                           hout.new_zeros((b, 1, d))], dim=1)
        per_k = h_pad[bidx[:, :, None], flat_slot]           # (B, g, k, d)
        wts = top_p.to(dt) * kept.to(dt)
        yg = torch.einsum("bgk,bgkd->bgd", wts, per_k)
    else:
        # GShard one-hot dispatch.  A token's k experts differ, so each
        # (token, expert) has at most one nonzero k term: summing over k
        # first and taking the one-hot of the summed place gives the
        # reference's values exactly
        keep_e = keep.sum(2)                                 # (B, g, E)
        place = (pos_idx * sel.long()).sum(2)
        onehot = F.one_hot(torch.clamp(place, max=cap - 1), cap).float()
        disp = keep_e[..., None] * onehot                    # (B, g, E, C)
        comb = (keep * top_p[..., None]).sum(2)[..., None] * onehot
        xin = torch.einsum("bgec,bgd->becd", disp.to(dt), xg)
        hout = _experts(p, xin, cfg)
        yg = torch.einsum("bgec,becd->bgd", comb.to(dt), hout)
    # load-balancing aux (Switch): E · Σ_e f_e · P_e
    f_e = sel_any.mean(1)
    p_e = probs.mean(1)
    return yg, e * (f_e * p_e).sum(-1)


def apply_moe(p: MoE, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped top-k capacity routing.  The sequence is cut into waves of
    ``moe_group_size`` tokens per batch row; each (wave, row) routes alone
    with capacity C = g·k·cf/E, the batch a tensor dim, the waves in turn
    (bounding the (g, E, C) one-hots).  Returns (out, the Switch aux loss:
    the mean over rows, then over waves)."""
    b, s, d = x.shape
    g = min(cfg.moe_group_size, s)
    if s % g:
        raise ValueError(f"MoE: sequence length {s} is not a multiple of "
                         f"the routing group {g}")
    ys: List[torch.Tensor] = []
    auxs: List[torch.Tensor] = []
    for lo in range(0, s, g):
        yw, aux = _route_groups(p, x[:, lo: lo + g], cfg)
        ys.append(yw)
        auxs.append(aux.mean())
    return torch.cat(ys, dim=1), torch.stack(auxs).mean()
