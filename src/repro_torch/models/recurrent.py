"""Recurrent blocks: RG-LRU (RecurrentGemma / Griffin) and xLSTM (mLSTM,
sLSTM), the port of the JAX package's ``repro.models.recurrent``.

  * RG-LRU — an elementwise linear recurrence h_t = a_t h_{t-1} + b_t over
    gates from block-diagonal projections of a causal conv; the reference
    runs ``lax.associative_scan`` over time, the port a log-depth doubling
    scan in plain PyTorch (ceil(log2 S) passes, 11 at S = 2,048).
  * mLSTM — matrix-memory recurrence in chunkwise-parallel form: intra-chunk
    attention-like products + inter-chunk state carry (exp-gate stabilised in
    log space), plain PyTorch as the JAX package computes it in jnp.
  * sLSTM — sequential (the hidden state feeds the gates): the input-side
    gates are one matrix product, the recurrence over the sequence is the
    ``slstm_sequence`` CUDA kernel (B8) on the card, its plain version on
    the CPU; under grad its backward is the ``slstm_backward`` kernel (B8ᵀ)
    or the plain reverse loop (``kernels/slstm.py``'s ``SLSTMSequence``).
    The JAX package runs the same cell through ``lax.scan``.

All three expose a single-token ``*_decode`` path with explicit state (plain
PyTorch: one cell step per token).

Parameters live in ``nn.Module``s whose attribute names are the JAX
package's dict keys (``models/convert.py`` relies on it); the math is in
plain functions of (module, tensors), cast for cast as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..kernels.ref import slstm_cell
from .config import ModelConfig
from .layers import _init, _param

CONV_WIDTH = 4
LRU_C = 8.0          # Griffin's gate sharpness constant
N_GATE_BLOCKS = 4    # block-diagonal gate projections


# ---------------------------------------------------------------------------
# depthwise causal temporal conv (the RG-LRU and mLSTM branches)
# ---------------------------------------------------------------------------

class Conv(nn.Module):
    def __init__(self, channels: int, device):
        super().__init__()
        self.w = _param((CONV_WIDTH, channels), device)
        self.b = _param((channels,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _init(self.w, generator, scale=0.5)
        with torch.no_grad():
            self.b.zero_()


def apply_conv(p: Conv, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, C) -> causal depthwise conv, width CONV_WIDTH; the taps are
    summed in the reference's order, from 0."""
    dt = x.dtype
    pads = F.pad(x, (0, 0, CONV_WIDTH - 1, 0))
    out = sum(pads[:, i: i + x.shape[1], :] * p.w[i].to(dt)
              for i in range(CONV_WIDTH))
    return out + p.b.to(dt)


def apply_conv_decode(p: Conv, x_t: torch.Tensor,
                      cache: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t (B, C), cache (B, CONV_WIDTH-1, C) of previous inputs."""
    dt = x_t.dtype
    win = torch.cat([cache, x_t[:, None, :]], dim=1)          # (B, W, C)
    out = torch.einsum("bwc,wc->bc", win, p.w.to(dt)) + p.b.to(dt)
    return out, win[:, 1:, :]


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

class RGLRU(nn.Module):
    """``w_x`` / ``w_y`` (d, w) input and gate branches, ``conv``,
    ``gate_a`` / ``gate_i`` (4, w/4, w/4) block-diagonal gates, ``b_a`` /
    ``b_i`` (w,), ``lam`` (w,) and ``w_out`` (w, d)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width
        blk = w // N_GATE_BLOCKS
        self.w_x = _param((d, w), device)
        self.w_y = _param((d, w), device)
        self.conv = Conv(w, device)
        self.gate_a = _param((N_GATE_BLOCKS, blk, blk), device)
        self.gate_i = _param((N_GATE_BLOCKS, blk, blk), device)
        self.b_a = _param((w,), device)
        self.b_i = _param((w,), device)
        self.lam = _param((w,), device)
        self.w_out = _param((w, d), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's draws, its quirk included: ``_init`` scales by
        the leading dim, so the (4, blk, blk) gates get 1/sqrt(4)."""
        _init(self.w_x, generator)
        _init(self.w_y, generator)
        self.conv.reset_parameters(generator)
        _init(self.gate_a, generator)
        _init(self.gate_i, generator)
        with torch.no_grad():
            self.b_a.zero_()
            self.b_i.zero_()
            # so that a = sigmoid(lam)^c spreads over (0.9, 0.999)
            self.lam.copy_(torch.linspace(2.0, 6.0, self.lam.shape[0],
                                          dtype=torch.float32))
        _init(self.w_out, generator)


def _block_diag_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., W) with W = NB·blk; w (NB, blk, blk); in x's dtype."""
    nb, blk, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, blk)
    return torch.einsum("...nb,nbc->...nc", xs,
                        w.to(x.dtype)).reshape(x.shape)


def _rglru_coeffs(p: RGLRU, u: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u (B, S, W) post-conv input -> fp32 (a_t, b_t) of
    h_t = a_t h_{t-1} + b_t."""
    r = torch.sigmoid(_block_diag_proj(u, p.gate_a).float() + p.b_a)
    i = torch.sigmoid(_block_diag_proj(u, p.gate_i).float() + p.b_i)
    log_a = -LRU_C * r * F.softplus(p.lam)                   # log a_t <= 0
    a = torch.exp(log_a)
    # sqrt(1 - a^2) in a numerically safe form
    gate = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, gate * (i * u.float())


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, by doubling:
    after the pass at offset o, (a_t, b_t) is the composition of steps
    t-2o+1 .. t, so ceil(log2 S) passes cover the sequence."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        if 2 * off < s:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def apply_rglru(p: RGLRU, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence RG-LRU block body (the caller adds the residual)."""
    dt = x.dtype
    y = F.gelu(x @ p.w_y.to(dt), approximate="tanh")
    u = apply_conv(p.conv, x @ p.w_x.to(dt))
    a, b = _rglru_coeffs(p, u)
    h = linear_scan(a, b)
    return (h.to(dt) * y) @ p.w_out.to(dt)


class RGLRUState(NamedTuple):
    h: torch.Tensor      # (B, W) fp32
    conv: torch.Tensor   # (B, CONV_WIDTH-1, W)


def rglru_init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> RGLRUState:
    w = cfg.lru_width
    return RGLRUState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, CONV_WIDTH - 1, w), dtype=dtype,
                         device=device))


def apply_rglru_decode(p: RGLRU, x_t: torch.Tensor, state: RGLRUState,
                       cfg: ModelConfig) -> Tuple[torch.Tensor, RGLRUState]:
    """x_t (B, d) -> (out (B, d), new state)."""
    dt = x_t.dtype
    y = F.gelu(x_t @ p.w_y.to(dt), approximate="tanh")
    u_t, conv = apply_conv_decode(p.conv, x_t @ p.w_x.to(dt), state.conv)
    a, b = _rglru_coeffs(p, u_t[:, None, :])
    h = a[:, 0] * state.h + b[:, 0]
    out = (h.to(dt) * y) @ p.w_out.to(dt)
    return out, RGLRUState(h=h, conv=conv)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory) — chunkwise parallel
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        dm = int(d * cfg.mlstm_proj_factor)
        blk = dm // h
        self.w_up = _param((d, dm), device)
        self.w_z = _param((d, dm), device)           # output-gate branch
        self.conv = Conv(dm, device)
        # q/k/v are block-diagonal per head (xLSTM's BlockDiagonal linear)
        self.w_q = _param((h, blk, blk), device)
        self.w_k = _param((h, blk, blk), device)
        self.w_v = _param((h, blk, blk), device)
        self.w_i = _param((dm, h), device)
        self.w_f = _param((dm, h), device)
        self.b_i = _param((h,), device)
        self.b_f = _param((h,), device)
        self.w_down = _param((dm, d), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        blk = self.w_q.shape[1]
        _init(self.w_up, generator)
        _init(self.w_z, generator)
        self.conv.reset_parameters(generator)
        for w in (self.w_q, self.w_k, self.w_v):
            _init(w, generator, scale=1.0 / blk ** 0.5)
        _init(self.w_i, generator, scale=0.02)
        _init(self.w_f, generator, scale=0.02)
        with torch.no_grad():
            self.b_i.zero_()
            self.b_f.fill_(3.0)                       # open forget gates
        _init(self.w_down, generator)


class MLSTMState(NamedTuple):
    c: torch.Tensor     # (B, H, dk, dv) fp32, scale-free (true C = c * exp(m))
    n: torch.Tensor     # (B, H, dk) fp32
    m: torch.Tensor     # (B, H) fp32 log-stabiliser
    conv: torch.Tensor  # (B, CONV_WIDTH-1, dm)


def mlstm_init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> MLSTMState:
    dm = int(cfg.d_model * cfg.mlstm_proj_factor)
    h = cfg.n_heads
    dk = dm // h
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        c=torch.zeros((batch, h, dk, dk), **f32),
        n=torch.zeros((batch, h, dk), **f32),
        m=torch.full((batch, h), -1e30, **f32),
        conv=torch.zeros((batch, CONV_WIDTH - 1, dm), dtype=dtype,
                         device=device))


def _head_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Block-diagonal per-head projection: (..., dm) × (H, blk, blk) ->
    (..., H, blk)."""
    h, blk, _ = w.shape
    xs = x.reshape(*x.shape[:-1], h, blk)
    return torch.einsum("...hb,hbc->...hc", xs, w.to(x.dtype))


def _mlstm_qkv_gates(p: MLSTM, x: torch.Tensor, cfg: ModelConfig):
    dt = x.dtype
    h = cfg.n_heads
    u = x @ p.w_up.to(dt)
    z = x @ p.w_z.to(dt)
    c = F.silu(apply_conv(p.conv, u))
    dk = u.shape[-1] // h
    q = _head_proj(c, p.w_q).transpose(1, 2)                 # (B,H,S,dk)
    k = _head_proj(c, p.w_k).transpose(1, 2) / (dk ** 0.5)
    v = _head_proj(u, p.w_v).transpose(1, 2)
    cf = c.float()
    # fp32 products, a bf16-cast weight promoted (as jnp promotes it)
    log_i = (cf @ p.w_i.float() + p.b_i).transpose(1, 2)     # (B,H,S)
    log_f = F.logsigmoid(cf @ p.w_f.float() + p.b_f).transpose(1, 2)
    return q, k, v, log_i, log_f, z


def _mlstm_chunk(C, N, m, qb, kb, vb, li, lf, sdt):
    """One chunk of the chunkwise-parallel mLSTM: the chunk's outputs h
    (B, H, c, dv) and the state carried to the chunk's end."""
    c_len = qb.shape[2]
    C, N = C.float(), N.float()
    qf, kf, vf = qb.float(), kb.float(), vb.float()
    Fc = torch.cumsum(lf, dim=-1)                     # (B,H,c) Σ_{l<=i} log f
    # intra logits l_ij = F_i - F_j + li_j  (j <= i)
    lmat = Fc[..., :, None] - Fc[..., None, :] + li[..., None, :]
    tri = torch.ones((c_len, c_len), dtype=torch.bool,
                     device=lmat.device).tril()
    lmat = lmat.masked_fill(~tri, float("-inf"))
    a_i = lmat.amax(-1)                               # (B,H,c)
    e_i = Fc + m[..., None]                           # inter exponent
    m_i = torch.maximum(a_i, e_i)
    w_intra = torch.exp(lmat - m_i[..., None])        # (B,H,c,c)
    w_inter = torch.exp(e_i - m_i)                    # (B,H,c)
    scores = (qf @ kf.transpose(-1, -2)) * w_intra
    h_num = scores @ vf
    h_num = h_num + w_inter[..., None] * (qf @ C)
    n_vec = w_intra @ kf
    n_vec = n_vec + w_inter[..., None] * N[:, :, None, :]
    qn = (qf * n_vec).sum(-1)
    denom = torch.maximum(qn.abs(), torch.exp(-m_i))
    h = h_num / denom[..., None]                      # (B,H,c,dv)
    # state update to the end of the chunk
    last = Fc[..., -1:]
    l_end = last - Fc + li                            # (B,H,c)
    m_new = torch.maximum(last[..., 0] + m, l_end.amax(-1))
    w_end = torch.exp(l_end - m_new[..., None])
    decay = torch.exp(last[..., 0] + m - m_new)
    C_new = (decay[..., None, None] * C
             + (kf * w_end[..., None]).transpose(-1, -2) @ vf)
    N_new = decay[..., None] * N + (w_end[..., None] * kf).sum(-2)
    return C_new.to(sdt), N_new.to(sdt), m_new, h


def apply_mlstm(p: MLSTM, x: torch.Tensor, cfg: ModelConfig,
                chunk: int | None = None) -> torch.Tensor:
    """Full-sequence mLSTM block body, chunkwise-parallel, log-stabilised.
    S must be a multiple of min(chunk or cfg.mlstm_chunk, S)."""
    b, s, _ = x.shape
    dt = x.dtype
    nh = cfg.n_heads
    sdt = getattr(torch, cfg.mlstm_state_dtype)
    q, k, v, log_i, log_f, z = _mlstm_qkv_gates(p, x, cfg)
    dk = q.shape[-1]
    c_len = min(chunk or cfg.mlstm_chunk, s)
    if s % c_len:
        raise ValueError(f"mLSTM: sequence length {s} is not a multiple of "
                         f"the chunk {c_len}")
    C = torch.zeros((b, nh, dk, dk), dtype=sdt, device=x.device)
    N = torch.zeros((b, nh, dk), dtype=sdt, device=x.device)
    m = torch.full((b, nh), -1e30, dtype=torch.float32, device=x.device)
    hs = []
    for lo in range(0, s, c_len):
        sl = slice(lo, lo + c_len)
        C, N, m, h = _mlstm_chunk(C, N, m, q[:, :, sl], k[:, :, sl],
                                  v[:, :, sl], log_i[..., sl],
                                  log_f[..., sl], sdt)
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2).reshape(b, s, nh * dk).to(dt)
    return (h * F.silu(z)) @ p.w_down.to(dt)


def apply_mlstm_decode(p: MLSTM, x_t: torch.Tensor, state: MLSTMState,
                       cfg: ModelConfig) -> Tuple[torch.Tensor, MLSTMState]:
    """x_t (B, d) single-token mLSTM step."""
    b, d = x_t.shape
    dt = x_t.dtype
    nh = cfg.n_heads
    dm = int(d * cfg.mlstm_proj_factor)
    u = x_t @ p.w_up.to(dt)
    z = x_t @ p.w_z.to(dt)
    cin, conv = apply_conv_decode(p.conv, u, state.conv)
    cin = F.silu(cin)
    dk = dm // nh
    q = _head_proj(cin, p.w_q).float()                       # (B,H,dk)
    k = (_head_proj(cin, p.w_k) / (dk ** 0.5)).float()
    v = _head_proj(u, p.w_v).float()
    cf = cin.float()
    log_i = cf @ p.w_i + p.b_i                               # (B,H)
    log_f = F.logsigmoid(cf @ p.w_f + p.b_f)

    m_new = torch.maximum(log_f + state.m, log_i)
    w_prev = torch.exp(log_f + state.m - m_new)
    w_in = torch.exp(log_i - m_new)
    C = (w_prev[..., None, None] * state.c
         + w_in[..., None, None] * (k[..., :, None] * v[..., None, :]))
    N = w_prev[..., None] * state.n + w_in[..., None] * k
    qn = (q * N).sum(-1)
    denom = torch.maximum(qn.abs(), torch.exp(-m_new))
    h = (q[..., None, :] @ C)[..., 0, :] / denom[..., None]
    h = h.reshape(b, nh * dk).to(dt)
    out = (h * F.silu(z)) @ p.w_down.to(dt)
    return out, MLSTMState(c=C, n=N, m=m_new, conv=conv)


# ---------------------------------------------------------------------------
# sLSTM — block-diagonal per-head recurrence (B8 over the sequence)
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        blk = d // h
        ds = int(d * cfg.slstm_proj_factor)
        self.w_in = _param((d, 4 * d), device)       # i,f,z,o input paths
        self.r = _param((4, h, blk, blk), device)
        self.b = _param((4 * d,), device)
        self.w_ff1 = _param((d, ds), device)
        self.w_ff2 = _param((ds, d), device)
        self.ffn_norm = _param((d,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d = self.w_in.shape[0]
        blk = self.r.shape[2]
        _init(self.w_in, generator)
        _init(self.r, generator, scale=1.0 / blk ** 0.5)
        with torch.no_grad():
            self.b.zero_()
            self.b[d:2 * d] = 3.0                     # open forget gates
        _init(self.w_ff1, generator)
        _init(self.w_ff2, generator)
        with torch.no_grad():
            self.ffn_norm.fill_(1.0)


class SLSTMState(NamedTuple):
    h: torch.Tensor   # (B, d) fp32
    c: torch.Tensor   # (B, d)
    n: torch.Tensor   # (B, d)
    m: torch.Tensor   # (B, d)


def slstm_init_state(cfg: ModelConfig, batch: int, device) -> SLSTMState:
    def z():
        return torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                           device=device)
    return SLSTMState(h=z(), c=z(), n=z(),
                      m=torch.full((batch, cfg.d_model), -1e30,
                                   dtype=torch.float32, device=device))


def _slstm_cell(p: SLSTM, gates_x: torch.Tensor, state: SLSTMState,
                nh: int) -> Tuple[torch.Tensor, SLSTMState]:
    """gates_x (B, 4d) precomputed input-side gates for one step."""
    new = SLSTMState(*slstm_cell(gates_x, p.r, p.b, *state, nh))
    return new.h, new


def _slstm_ffn(p: SLSTM, h: torch.Tensor) -> torch.Tensor:
    """h + the post-FFN (tanh-approximate gelu, as ``jax.nn.gelu``),
    RMS-normed on h in fp32."""
    dt = h.dtype
    hf = h.float()
    ms = hf.square().mean(-1, keepdim=True)
    hn = (hf * torch.rsqrt(ms + 1e-6) * p.ffn_norm).to(dt)
    return h + F.gelu(hn @ p.w_ff1.to(dt), approximate="tanh") \
        @ p.w_ff2.to(dt)


def apply_slstm(p: SLSTM, x: torch.Tensor, cfg: ModelConfig, *,
                force_ref: bool = False) -> torch.Tensor:
    """Full-sequence sLSTM body + post-FFN: the input-side gates in one
    product, the recurrence on the ``slstm_sequence`` kernel (its plain
    version for CPU tensors or under ``force_ref``)."""
    gates_x = x @ p.w_in.to(x.dtype)                         # (B,S,4d)
    h = ops.slstm_sequence(gates_x, p.r, p.b, n_heads=cfg.n_heads,
                           force_ref=force_ref)              # (B,S,d), dt
    return _slstm_ffn(p, h)


def apply_slstm_decode(p: SLSTM, x_t: torch.Tensor, state: SLSTMState,
                       cfg: ModelConfig) -> Tuple[torch.Tensor, SLSTMState]:
    g = x_t @ p.w_in.to(x_t.dtype)
    h, new_state = _slstm_cell(p, g, state, cfg.n_heads)
    return _slstm_ffn(p, h.to(x_t.dtype)), new_state
