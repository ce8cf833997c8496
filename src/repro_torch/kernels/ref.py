"""Plain PyTorch versions of the port's CUDA kernels (the correctness contract).

Each function is its counterpart in the JAX package's ``repro.kernels.ref``,
the gather kernels in batched form: the JAX package calls those under
``vmap`` (one query, one prune node at a time), the port passes the batch
axis to the kernel.  Packed BQ words are int32 holding the uint32 bits.
The CPU tests run these; ``chip_smoke.py`` holds each CUDA kernel to
its plain version on the card.  Nothing on the main path calls the kernels'
plain versions when the tensors lie on a card; only ``gathered_dists``, the
row-wise arithmetic they share, and ``slstm_cell``, the sLSTM decode step
(one cell step a token, which has no kernel in the JAX package either), are
also plain code of the main path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

#: an empty slot of an IVF list (``core/ivf.py``)
PAD = -1


def l2_distance_ref(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """(Q, D) × (N, D) -> (Q, N) squared L2, float32 accumulation:
    ‖q‖² + ‖x‖² − 2·q·x clamped at 0."""
    q, x = queries.float(), corpus.float()
    qq = (q * q).sum(1)
    xx = (x * x).sum(1)
    return torch.clamp_min(qq[:, None] + xx[None, :] - 2.0 * (q @ x.T), 0.0)


def dot_distance_ref(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """(Q, D) × (N, D) -> (Q, N) negative inner product, float32 accumulation."""
    return -(queries.float() @ corpus.float().T)


def topk_smallest(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries along the last dim of float x, ascending, ties
    broken by the lowest index: ``lax.top_k(-x, k)``'s order, signed zeros
    included, where ``torch.topk`` leaves the order of ties unspecified.
    Selects on a unique 64-bit key (order-preserving float bits above the
    column index), never sorting a whole row.  Returns (values, int64
    indices).  The fused ``l2_topk`` kernel selects on the same key."""
    x = x.float()
    # float bits -> int32 in the same order, -0.0 below +0.0 as in XLA's
    # total order; NaN above +inf
    bits = x.view(torch.int32)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    col = torch.arange(x.shape[-1], device=x.device, dtype=torch.int64)
    key = (ordered << 32) | col
    _, pos = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    return x.gather(-1, pos), pos


def l2_topk_ref(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                mode: str, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused scan's plain version: `topk_smallest` of the plain
    distances (l2 | dot | cosine = 1.0 + dot), columns where ``mask`` is
    False at +inf.  Returns (distances (Q, k), int64 columns (Q, k))."""
    if mode == "l2":
        d = l2_distance_ref(queries, corpus)
    else:
        d = dot_distance_ref(queries, corpus)
        if mode == "cosine":
            d = 1.0 + d
    if mask is not None:
        d = d.masked_fill(~mask[None, :], float("inf"))
    return topk_smallest(d, k)


def gathered_dists(q: torch.Tensor, rows: torch.Tensor,
                   metric: str) -> torch.Tensor:
    """q (Q, D) vs its own gathered rows (Q, M, D) -> (Q, M) raw scores
    (smaller == closer): diff-square-sum for ``l2``, ``-q·x`` otherwise.

    The arithmetic of ``beam_gather``'s plain versions below.  The upper-layer
    descent and the bulk builder's row distances, plain code in the JAX
    package as well, call it directly on rows they gathered themselves.
    """
    if metric == "l2":
        d = rows - q[:, None, :]
        return (d * d).sum(-1)
    return -torch.bmm(rows, q[:, :, None])[..., 0]


def beam_gather_l2_ref(q: torch.Tensor, ids: torch.Tensor,
                       corpus: torch.Tensor) -> torch.Tensor:
    """q (Q, D) × ids (Q, L) × corpus (N, D) -> (Q, L) squared L2.

    Diff-square-sum, not the norm expansion: the same float ops as the
    single-pop traversal, so width 1 reproduces it.
    """
    return gathered_dists(q, corpus[ids.long()], "l2")


def beam_gather_lists_ref(q: torch.Tensor, probe: torch.Tensor,
                          lists: torch.Tensor, list_len: torch.Tensor,
                          corpus: torch.Tensor) -> torch.Tensor:
    """q (Q, D) × probe (Q, P) list ids × lists (nlist, M) × list_len
    (nlist,) × corpus (N, D) -> (Q, P * M): `beam_gather_l2_ref` over the
    candidates ``lists[probe]`` (ids clamped to [0, N) as B1 clamps them),
    +inf where the slot is PAD or lies at or past its list's ``list_len``."""
    nq, p = probe.shape
    m = lists.shape[1]
    pr = probe.long()
    cand = lists[pr]                                          # (Q, P, M)
    live = (cand != PAD) & (torch.arange(m, device=lists.device)
                            < list_len[pr][..., None])
    cand, live = cand.reshape(nq, p * m), live.reshape(nq, p * m)
    d = beam_gather_l2_ref(q, cand.clamp(0, corpus.shape[0] - 1), corpus)
    return torch.where(live, d, float("inf"))


def beam_gather_lists_topk_ref(q: torch.Tensor, probe: torch.Tensor,
                               lists: torch.Tensor, list_len: torch.Tensor,
                               corpus: torch.Tensor, k: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused list-major entry's plain version: `topk_smallest` of
    `beam_gather_lists_ref`'s (Q, P * M) matrix at min(k, P * M); returns
    (distances, int64 columns)."""
    d = beam_gather_lists_ref(q, probe, lists, list_len, corpus)
    return topk_smallest(d, min(k, d.shape[1]))


def beam_gather_dot_ref(q: torch.Tensor, ids: torch.Tensor,
                        corpus: torch.Tensor) -> torch.Tensor:
    """q (Q, D) × ids (Q, L) × corpus (N, D) -> (Q, L) negated inner product."""
    return gathered_dists(q, corpus[ids.long()], "dot")


def pair_gather_l2_ref(ids: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """ids (B, C) × corpus (N, D) -> (B, C, C) pairwise squared L2 among
    each node's gathered candidate rows, norm-expansion form clamped at 0."""
    rows = corpus[ids.long()]                       # (B, C, D)
    g = torch.bmm(rows, rows.transpose(1, 2))
    nn = (rows * rows).sum(-1)
    return (nn[:, :, None] + nn[:, None, :] - 2.0 * g).clamp_min(0.0)


def pair_gather_dot_ref(ids: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """ids (B, C) × corpus (N, D) -> (B, C, C) negated pairwise inner products."""
    rows = corpus[ids.long()]
    return -torch.bmm(rows, rows.transpose(1, 2))


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of the low 32 bits of each integer -> int64 (SWAR on int64:
    torch has no popcount and no logical shift of int32, so the word is
    widened and masked before any shift)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def beam_gather_adc_ref(lut: torch.Tensor, ids: torch.Tensor,
                        codes: torch.Tensor) -> torch.Tensor:
    """lut (Q, m, k) × ids (Q, L) × codes (N, m) -> (Q, L) float32:
    Σᵢ lut[q, i, codes[ids[q, l], i]], added for i = 0, 1, ..., m-1 in turn
    (the CUDA kernel's order)."""
    rows = codes[ids.long()].long()                  # (Q, L, m)
    lut = lut.float()
    acc = lut[:, 0, :].gather(1, rows[:, :, 0])
    for i in range(1, lut.shape[1]):
        acc = acc + lut[:, i, :].gather(1, rows[:, :, i])
    return acc


def beam_gather_hamming_ref(q: torch.Tensor, ids: torch.Tensor,
                            codes: torch.Tensor) -> torch.Tensor:
    """q (Q, W) × ids (Q, L) × codes (N, W) -> (Q, L) int32 Hamming
    distances; words are int32 holding uint32 bits."""
    rows = codes[ids.long()]                         # (Q, L, W)
    return popcount32(rows ^ q[:, None, :]).sum(-1).to(torch.int32)


def beam_gather_hamming_masked_ref(q: torch.Tensor, ids: torch.Tensor,
                                   fresh: torch.Tensor,
                                   codes: torch.Tensor) -> torch.Tensor:
    """q (Q, W) × ids (Q, L) × fresh (Q, L) bool × codes (N, W) -> (Q, L)
    float32: the Hamming distance to codes[clamp(id, 0, N - 1)] where
    ``fresh`` is set, +inf where it is not (the BQ search step's distances;
    PAD = -1 allowed)."""
    d = beam_gather_hamming_ref(q, ids.clamp(0, codes.shape[0] - 1), codes)
    return torch.where(fresh, d.float(), float("inf"))


def pq_adc_ref(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut (Q, m, k) × codes (N, m) -> (Q, N) float32 ADC, accumulated one
    sub-space after the other: the (Q, N) sum is the largest intermediate
    (the JAX oracle's (m, Q, N) stack would be 64 GB at Q = 1024, N = 1M)."""
    lut = lut.float()
    c = codes.long()
    acc = lut[:, 0, c[:, 0]]
    for i in range(1, lut.shape[1]):
        acc = acc + lut[:, i, c[:, i]]
    return acc


def hamming_ref(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """q (Q, W) × x (N, W) -> (Q, N) int32 packed Hamming distances, words
    int32 holding uint32 bits, accumulated one word after the other (no
    (Q, N, W) intermediate)."""
    acc = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.int32,
                      device=x.device)
    for w in range(q.shape[1]):
        acc += popcount32(q[:, w, None] ^ x[None, :, w]).to(torch.int32)
    return acc


def _slstm_pre(gates_x: torch.Tensor, r: torch.Tensor, b: torch.Tensor,
               h: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, 4d) pre-activations gates_x + h·R + b in h's dtype."""
    bsz, d4 = gates_x.shape
    d = d4 // 4
    blk = d // n_heads
    acc = h.dtype
    rec = torch.einsum("bnk,gnkl->bgnl", h.reshape(bsz, n_heads, blk),
                       r.to(acc)).reshape(bsz, d4)
    return gates_x.to(acc) + rec + b.to(acc)


def _slstm_update(pre: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                  m: torch.Tensor):
    """The cell from its pre-activations: the new (h, c, n, m)."""
    gi, gf, gz, go = pre.chunk(4, dim=-1)
    log_f = torch.nn.functional.logsigmoid(gf)
    m_new = torch.maximum(log_f + m, gi)
    i_p = torch.exp(gi - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(gz)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(go) * c_new / torch.clamp_min(n_new, 1e-6)
    return h_new, c_new, n_new, m_new


def slstm_cell(gates_x: torch.Tensor, r: torch.Tensor, b: torch.Tensor,
               h: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
               m: torch.Tensor, n_heads: int):
    """One step of the stabilised exp-gate sLSTM cell, in the state's dtype
    (float32; float64 for a float64 state).

    gates_x (B, 4d) input-side gates, r (4, H, blk, blk) block-diagonal
    recurrent weights, b (4d,) biases; state h, c, n, m (B, d).  Gate g of
    unit n·blk + l reads pre[g·d + n·blk + l] and the column R[g, n, :, l].
    Returns the new (h, c, n, m).
    """
    return _slstm_update(_slstm_pre(gates_x, r, b, h, n_heads), c, n, m)


def _state_dtype(gates_x: torch.Tensor) -> torch.dtype:
    """float32 for bf16 / f32 gates, float64 for f64 ones (gradcheck)."""
    return torch.promote_types(gates_x.dtype, torch.float32)


def _slstm_init(bsz: int, d: int, dtype, device):
    state = [torch.zeros((bsz, d), dtype=dtype, device=device)
             for _ in range(3)]
    state.append(torch.full((bsz, d), -1e30, dtype=dtype, device=device))
    return state


def slstm_sequence_ref(gates_x: torch.Tensor, r: torch.Tensor,
                       b: torch.Tensor, n_heads: int) -> torch.Tensor:
    """gates_x (B, S, 4d) × r (4, H, blk, blk) × b (4d,) -> h (B, S, d) in
    the gates' dtype: the cell over the sequence from h = c = n = 0 and
    m = -1e30, state in float32 (``repro.kernels.ref.slstm_sequence_ref``)."""
    bsz, s, d4 = gates_x.shape
    d = d4 // 4
    state = _slstm_init(bsz, d, _state_dtype(gates_x), gates_x.device)
    out = torch.empty((bsz, s, d), dtype=gates_x.dtype, device=gates_x.device)
    for t in range(s):
        state = slstm_cell(gates_x[:, t], r, b, *state, n_heads)
        out[:, t] = state[0]
    return out


#: the fields of the sLSTM forward's save, (8, B, S, d) in the state's
#: dtype: what its backward reads at each step
SLSTM_SAVED = ("pre_i", "pre_f", "pre_z", "pre_o", "c", "n", "m", "h")


def slstm_sequence_save_ref(gates_x: torch.Tensor, r: torch.Tensor,
                            b: torch.Tensor, n_heads: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``slstm_sequence_ref`` that also returns what the backward reads:
    (h (B, S, d) in the gates' dtype, saved (8, B, S, d): each step's four
    pre-activations and its new c, n, m and h, in the state's dtype)."""
    bsz, s, d4 = gates_x.shape
    d = d4 // 4
    acc = _state_dtype(gates_x)
    state = _slstm_init(bsz, d, acc, gates_x.device)
    out = torch.empty((bsz, s, d), dtype=gates_x.dtype, device=gates_x.device)
    saved = torch.empty((8, bsz, s, d), dtype=acc, device=gates_x.device)
    for t in range(s):
        pre = _slstm_pre(gates_x[:, t], r, b, state[0], n_heads)
        state = _slstm_update(pre, *state[1:])
        saved[:4, :, t] = pre.reshape(bsz, 4, d).transpose(0, 1)
        saved[4:, :, t] = torch.stack(state[1:] + state[:1])
        out[:, t] = state[0]
    return out, saved


def slstm_sequence_backward_ref(dh: torch.Tensor, saved: torch.Tensor,
                                r: torch.Tensor, n_heads: int,
                                dtype: torch.dtype
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sLSTM sequence's backward, an explicit reverse loop: dh (B, S,
    d), the cotangent of h, and the forward's ``saved`` -> (dgates (B, S, 4d)
    in ``dtype``, dpre (B, S, 4d) in the state's dtype).

    The derivative autodiff of the cell gives, with (dc, dn, dm) carried
    from step t + 1 to t and dh_{t-1} += Σ_g dpre_g · R_gᵀ: through
    ``logsigmoid``, through the stabiliser m (h is not invariant to m where
    the clamp of n is active), through that clamp, and through
    ``maximum`` with ties split evenly (``jnp.maximum``'s rule; the clamp is
    ``jnp.maximum(n, 1e-6)`` in the reference)."""
    _, bsz, s, d = saved.shape
    acc = saved.dtype
    blk = d // n_heads
    r = r.to(acc)
    dpre = torch.empty((bsz, s, 4 * d), dtype=acc, device=saved.device)
    zero = torch.zeros((bsz, d), dtype=acc, device=saved.device)
    dc = dn = dm = drec = zero
    for t in reversed(range(s)):
        gi, gf, gz, go, c, n, m, _ = saved[:, :, t]
        if t > 0:
            cp, np_, mp = saved[4:7, :, t - 1]
        else:
            cp, np_, mp = zero, zero, torch.full_like(zero, -1e30)
        a = torch.nn.functional.logsigmoid(gf) + mp
        i_p = torch.exp(gi - m)
        f_p = torch.exp(a - m)
        tz = torch.tanh(gz)
        sg = torch.sigmoid(go)
        nc = torch.clamp_min(n, 1e-6)
        w_clamp = (n > 1e-6).to(acc) + 0.5 * (n == 1e-6).to(acc)
        d_h = dh[:, t].to(acc) + drec
        dgo = d_h * c / nc * sg * (1 - sg)
        dct = dc + d_h * sg / nc
        dnt = dn - d_h * sg * c / (nc * nc) * w_clamp
        x_f = (dct * cp + dnt * np_) * f_p
        x_i = (dct * tz + dnt) * i_p
        dgz = dct * i_p * (1 - tz * tz)
        dmt = dm - x_f - x_i
        w_a = (a > gi).to(acc) + 0.5 * (a == gi).to(acc)
        da = x_f + dmt * w_a
        dgi = x_i + dmt * (1 - w_a)
        dgf = da * torch.sigmoid(-gf)
        dp = torch.cat([dgi, dgf, dgz, dgo], dim=-1)
        dpre[:, t] = dp
        dc, dn, dm = dct * f_p, dnt * f_p, da
        drec = torch.einsum("bgnl,gnkl->bnk",
                            dp.reshape(bsz, 4, n_heads, blk),
                            r).reshape(bsz, d)
    return dpre.to(dtype), dpre


def slstm_param_grads(saved: torch.Tensor, dpre: torch.Tensor,
                      n_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dr (4, H, blk, blk), db (4d,)) from the saved h and dpre (B, S,
    4d): dr[g, n, k, l] = Σ_{b,t} h_{t-1}[b, n·blk + k] · dpre_t[b, g·d +
    n·blk + l] (h_{-1} = 0), db = Σ_{b,t} dpre_t: one product each, in the
    state's dtype (a float32 product on the card runs in full float32
    while ``torch.backends.cuda.matmul.allow_tf32`` is False, its
    default)."""
    _, bsz, s, d = saved.shape
    blk = d // n_heads
    h_prev = torch.zeros((bsz, s, d), dtype=saved.dtype, device=saved.device)
    h_prev[:, 1:] = saved[7, :, :-1]
    dr = torch.einsum("btnk,btgnl->gnkl",
                      h_prev.reshape(bsz, s, n_heads, blk),
                      dpre.reshape(bsz, s, 4, n_heads, blk))
    return dr, dpre.sum(dim=(0, 1))
