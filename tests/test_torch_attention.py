"""The port's attention, RoPE, MLPs, MoE and RG-LRU against the JAX
package's ``repro.models.layers`` / ``recurrent``, on the CPU.

Each layer's parameters come from the JAX package's own init and are
copied into the port's module; the same seeded numpy inputs go through
both.  Tolerances as in tests/test_torch_models.py: 1e-4 absolute in fp32
(``FP32_ATOL``), 0.15 in bf16 (``BF16_ATOL``), where the two frameworks
round at other places.  The attention routes are forced at a small S by
``dense_attn_threshold=16, attn_chunk=16`` in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import recurrent as jrec
from repro_torch import configs
from repro_torch.models import layers as tlayers
from repro_torch.models import recurrent as trec

FP32_ATOL = 1e-4
BF16_ATOL = 0.15
SMALL = dict(dense_attn_threshold=16, attn_chunk=16)


@pytest.fixture(autouse=True)
def _no_grad():
    """The port serves without autograd (the model's entry points run under
    ``torch.no_grad``); so do these layer calls."""
    with torch.no_grad():
        yield


def _cfgs(arch, dtype="float32", **kw):
    return (jconfigs.get_smoke_config(arch).with_overrides(dtype=dtype, **kw),
            configs.get_smoke_config(arch).with_overrides(dtype=dtype, **kw))


def _load(module, tree, rng=None):
    """Copy the JAX dict's leaves into the module's parameters (by the
    shared names); with rng, first give the leaves that the init leaves
    constant (biases, norm scales) random values, in both."""
    with torch.no_grad():
        for name, prm in module.named_parameters():
            node = tree
            *path, leaf = name.split(".")
            for k in path:
                node = node[k]
            arr = np.asarray(node[leaf])
            if rng is not None and np.all(arr == arr.flat[0]):
                arr = (arr + 0.3 * rng.randn(*arr.shape)).astype(np.float32)
                node[leaf] = jnp.asarray(arr)
            prm.copy_(torch.as_tensor(np.array(arr)))
    return module


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    tol = FP32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _x(seed, *shape, dtype="float32"):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return (jnp.asarray(x).astype(dtype),
            torch.as_tensor(x).to(getattr(torch, dtype)))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,rope_pct", [("qwen2-1.5b", 1.0),
                                           ("stablelm-3b", 0.25),
                                           ("qwen2-1.5b", 0.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(arch, rope_pct, dtype):
    jcfg, cfg = _cfgs(arch, dtype, rope_pct=rope_pct)
    jx, tx = _x(1, 2, 9, 4, jcfg.head_dim, dtype=dtype)
    pos = np.random.RandomState(2).randint(0, 5000, (2, 9)).astype(np.int32)
    want = jlayers.apply_rope(jx, jnp.asarray(pos), jcfg)
    got = tlayers.apply_rope(tx, torch.as_tensor(pos), cfg)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)
    rot = int(cfg.head_dim * rope_pct) // 2 * 2
    # the dims past rot are untouched; the pairs are interleaved, not halves
    assert torch.equal(got[..., rot:], tx[..., rot:])
    if rot:
        np.testing.assert_allclose(
            tlayers.rope_frequencies(cfg).numpy(),
            np.asarray(jlayers.rope_frequencies(jcfg)), rtol=1e-6)
        halves = torch.cat([tx[..., :rot:2], tx[..., 1:rot:2]], -1)
        assert not torch.allclose(got[..., :rot], halves)


# ---------------------------------------------------------------------------
# attention_full: three routes, causal / window / cross
# ---------------------------------------------------------------------------

def _attn(arch, dtype, **kw):
    jcfg, cfg = _cfgs(arch, dtype, **SMALL, **kw)
    jp = jlayers.init_attention(jax.random.PRNGKey(3), jcfg)
    jp = dict(jp)
    tp = _load(tlayers.Attention(cfg, "cpu"), jp,
               np.random.RandomState(4))
    return jcfg, cfg, jp, tp


# the extent schedule is causal only: cross attention (non-causal) with
# attn_schedule="extent" takes the masked one, and is the chunked case
ROUTES = [(route, s, schedule, mask)
          for route, s, schedule in (("dense", 16, "masked"),
                                     ("chunked", 64, "masked"),
                                     ("extent", 64, "extent"))
          for mask in ("causal", "window", "cross")
          if (route, mask) != ("extent", "cross")]


@pytest.mark.parametrize("route,s,schedule,mask", ROUTES)
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-4b"])
def test_attention_full_routes_match_jax(route, s, schedule, mask, arch):
    jcfg, cfg, jp, tp = _attn(arch, "float32", attn_schedule=schedule)
    b, d = 2, cfg.d_model
    jx, tx = _x(5, b, s, d)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    causal, window, jkv, tkv = True, 0, None, None
    if mask == "window":
        window = 24            # some (q, kv) chunk pairs wholly masked
    if mask == "cross":
        causal = False
        t = s if route != "dense" else 24
        rng = np.random.RandomState(6)
        k = rng.randn(b, t, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
        v = rng.randn(b, t, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
        kp = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
        jkv = (jnp.asarray(k), jnp.asarray(v), jnp.asarray(kp))
        tkv = tuple(torch.as_tensor(a) for a in (k, v, kp))
    want_route = route
    assert tlayers.attention_route(cfg, s, tkv[0].shape[1] if tkv else s,
                                   causal, cfg.attn_chunk) == want_route
    want = jlayers.attention_full(jp, jx, jcfg, jnp.asarray(pos),
                                  causal=causal, window=window,
                                  kv_override=jkv)
    got = tlayers.attention_full(tp, tx, cfg, torch.as_tensor(pos),
                                 causal=causal, window=window,
                                 kv_override=tkv)
    _close(got, want, "float32")
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("route,schedule", [("dense", "masked"),
                                            ("chunked", "masked"),
                                            ("extent", "extent")])
def test_attention_full_bf16_matches_jax(route, schedule):
    s = 16 if route == "dense" else 64
    jcfg, cfg, jp, tp = _attn("qwen2-1.5b", "bfloat16",
                              attn_schedule=schedule)
    jx, tx = _x(7, 2, s, cfg.d_model, dtype="bfloat16")
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want = jlayers.attention_full(jp, jx, jcfg, jnp.asarray(pos), window=24)
    got = tlayers.attention_full(tp, tx, cfg, torch.as_tensor(pos),
                                 window=24)
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


def test_chunked_attention_has_fp32_scores():
    """bf16 q and k whose dot products need more than bf16's 8 bits: the
    chunked route's output equals the dense route's on the same inputs
    (both fp32 scores), up to the online softmax's rounding."""
    _, cfg = _cfgs("qwen2-1.5b", "bfloat16", **SMALL)
    rng = np.random.RandomState(8)
    b, s, nkv, g, dh = 1, 32, 2, 2, 16
    q = torch.as_tensor(3 * rng.randn(b, s, nkv, g, dh)).bfloat16()
    k = torch.as_tensor(3 * rng.randn(b, s, nkv, dh)).bfloat16()
    v = torch.as_tensor(rng.randn(b, s, nkv, dh)).bfloat16()
    pos = torch.arange(s, dtype=torch.int32)[None]
    sc = tlayers._scores(q, k)
    assert sc.dtype == torch.float32
    want = torch.einsum("bsngh,btnh->bngst", q.double(), k.double()) / 4.0
    assert (sc.double() - want).abs().max() < 1e-4
    dense = tlayers._sdpa(q, k, v, tlayers._mask_bias(pos, pos, True, 0))
    chunked = tlayers._chunked_attention(q, k, v, pos, pos, True, 0, 16)
    assert (dense.float() - chunked.float()).abs().max() < 0.05


# ---------------------------------------------------------------------------
# attention_decode: ragged, uniform, ring, writes past the end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["ragged", "uniform"])
@pytest.mark.parametrize("ring,window,s_cache", [(False, 0, 12),
                                                 (False, 5, 12),
                                                 (True, 6, 6)])
def test_attention_decode_matches_jax(mode, ring, window, s_cache):
    jcfg, cfg, jp, tp = _attn("qwen3-4b", "float32", decode_pos_mode=mode)
    b, d = 3, cfg.d_model
    shape = (b, s_cache, cfg.n_kv_heads, cfg.head_dim)
    jk = jv = jnp.zeros(shape)
    tk = tv = torch.zeros(shape)
    start = np.array([0, 2, 5] if mode == "ragged" else [3, 3, 3], np.int32)
    steps = 10 if ring else s_cache - int(start.max())
    for t in range(steps):
        pos = start + t
        jx, tx = _x(10 + t, b, 1, d)
        jo, jk, jv = jlayers.attention_decode(jp, jx, jk, jv, jnp.asarray(pos),
                                              jcfg, window=window, ring=ring)
        to, tk, tv = tlayers.attention_decode(tp, tx, tk, tv,
                                              torch.as_tensor(pos), cfg,
                                              window=window, ring=ring)
        _close(to, jo, "float32")
        _close(tk, jk, "float32")
        _close(tv, jv, "float32")


@pytest.mark.parametrize("mode", ["ragged", "uniform"])
def test_attention_decode_write_past_the_cache_end(mode):
    """No ring, pos >= S_cache: the reference's ragged scatter drops the
    write, its uniform dynamic_update_slice clamps it to the last slot; the
    port does the same."""
    jcfg, cfg, jp, tp = _attn("qwen2-1.5b", "float32", decode_pos_mode=mode)
    b, s_cache = 2, 4
    rng = np.random.RandomState(11)
    shape = (b, s_cache, cfg.n_kv_heads, cfg.head_dim)
    ck = rng.randn(*shape).astype(np.float32)
    cv = rng.randn(*shape).astype(np.float32)
    pos = np.array([5, 4] if mode == "ragged" else [6, 6], np.int32)
    jx, tx = _x(12, b, 1, cfg.d_model)
    jo, jk, jv = jlayers.attention_decode(jp, jx, jnp.asarray(ck),
                                          jnp.asarray(cv), jnp.asarray(pos),
                                          jcfg)
    to, tk, tv = tlayers.attention_decode(tp, tx, torch.as_tensor(ck),
                                          torch.as_tensor(cv),
                                          torch.as_tensor(pos), cfg)
    _close(to, jo, "float32")
    _close(tk, jk, "float32")
    _close(tv, jv, "float32")
    if mode == "ragged":
        np.testing.assert_array_equal(tk.numpy(), ck)       # dropped
        np.testing.assert_array_equal(np.asarray(jk), ck)
    else:                                                   # the last slot
        for got in (tk.numpy(), np.asarray(jk)):
            np.testing.assert_array_equal(got[:, :-1], ck[:, :-1])
            assert not np.isclose(got[:, -1], ck[:, -1]).any()


def test_cache_write_is_functional():
    cache = torch.zeros(2, 3, 1, 2)
    new = torch.ones(2, 1, 2)
    out = tlayers._cache_write(cache, new, torch.tensor([1, 2]), False)
    assert cache.abs().sum() == 0
    assert out[0, 1].sum() == 2 and out[1, 2].sum() == 2 and out.sum() == 4


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mlp_type", [("qwen2-1.5b", "swiglu"),
                                           ("recurrentgemma-9b", "geglu"),
                                           ("starcoder2-15b", "gelu")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_jax(arch, mlp_type, dtype):
    jcfg, cfg = _cfgs(arch, dtype)
    assert cfg.mlp_type == mlp_type
    jp = dict(jlayers.init_mlp(jax.random.PRNGKey(13), jcfg))
    tp = _load(tlayers.MLP(cfg, "cpu"), jp, np.random.RandomState(14))
    jx, tx = _x(15, 2, 7, cfg.d_model, dtype=dtype)
    _close(tlayers.apply_mlp(tp, tx, cfg), jlayers.apply_mlp(jp, jx, jcfg),
           dtype)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe(arch, dtype, **kw):
    """The reference's init scales the stacked experts by 1/sqrt(E) (its
    ``_init`` takes the leading dim); here each expert matrix gets its
    fan-in's scale instead, so the outputs are O(1) and the absolute
    tolerances mean what they say."""
    jcfg, cfg = _cfgs(arch, dtype, **kw)
    jp = dict(jlayers.init_moe(jax.random.PRNGKey(16), jcfg))
    for name in ("wg", "wu", "wd"):
        if name in jp:
            w = jp[name]
            jp[name] = w * (w.shape[0] / w.shape[1]) ** 0.5
    tp = _load(tlayers.MoE(cfg, "cpu"), jp)
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("arch,s", [("granite-moe-3b-a800m", 64),
                                    ("granite-moe-3b-a800m", 192),
                                    ("mixtral-8x7b", 128),
                                    ("granite-moe-3b-a800m", 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_matches_jax(dispatch, arch, s, dtype):
    """One wave (s = the group of 64), three and two waves, and a decode
    step's group of one token; the router scaled up so that capacity drops
    tokens."""
    jcfg, cfg, jp, tp = _moe(arch, dtype, moe_dispatch=dispatch)
    with torch.no_grad():
        tp.router.mul_(50.0)
    jp["router"] = jnp.asarray(tp.router.numpy())
    jx, tx = _x(17, 3, s, cfg.d_model, dtype=dtype)
    jy, jaux = jlayers.apply_moe(jp, jx, jcfg)
    ty, taux = tlayers.apply_moe(tp, tx, cfg)
    assert ty.dtype == tx.dtype and taux.dtype == torch.float32
    _close(ty, jy, dtype)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("ties", ["all", "kth"])
def test_moe_ties_break_by_expert_index(dispatch, ties):
    """Router logits that tie at the k-th place: ``lax.top_k`` takes the
    lowest index, and so must the port (``torch.topk`` promises no order
    among ties).  "all": a zero router, every expert tied for every token;
    "kth": experts 5 and 2 share a router column."""
    jcfg, cfg, jp, tp = _moe("granite-moe-3b-a800m", "float32",
                             moe_dispatch=dispatch)
    with torch.no_grad():
        if ties == "all":
            tp.router.zero_()
        else:
            tp.router.mul_(30.0)
            tp.router[:, 5] = tp.router[:, 2]
    jp["router"] = jnp.asarray(tp.router.numpy())
    jx, tx = _x(18, 2, 64, cfg.d_model)
    jy, jaux = jlayers.apply_moe(jp, jx, jcfg)
    ty, taux = tlayers.apply_moe(tp, tx, cfg)
    _close(ty, jy, "float32")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    probs = torch.softmax(tx @ tp.router, -1)
    _, top_e = tlayers.top_k_lowest_index(probs, cfg.moe_top_k)
    _, jtop = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.moe_top_k)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop))
    if ties == "kth":
        # some token has the tied pair at its k-th place
        assert ((top_e[..., -1] == 2) & (probs[..., 2] == probs[..., 5])
                ).any()


def test_top_k_lowest_index_matches_lax_top_k():
    x = np.random.RandomState(19).randint(0, 4, (50, 40)).astype(np.float32)
    for k in (1, 2, 8, 40):
        v, i = tlayers.top_k_lowest_index(torch.as_tensor(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("group,cf", [(1, 1.25), (64, 1.25), (1024, 1.25),
                                      (7, 0.5), (100, 3.0)])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x7b"])
def test_moe_capacity_matches_jax(group, cf, arch):
    jcfg, cfg = (c.with_overrides(moe_capacity_factor=cf)
                 for c in (jconfigs.get_config(arch),
                           configs.get_config(arch)))
    assert tlayers.moe_capacity(cfg, group) == jlayers.moe_capacity(jcfg,
                                                                    group)


def test_moe_group_must_divide_the_sequence():
    _, cfg, _, tp = _moe("granite-moe-3b-a800m", "float32")
    with pytest.raises(ValueError, match="routing group"):
        tlayers.apply_moe(tp, torch.zeros(1, 96, cfg.d_model), cfg)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rglru(dtype):
    jcfg, cfg = _cfgs("recurrentgemma-9b", dtype)
    jp = jax.tree_util.tree_map(
        lambda a: a, jrec.init_rglru(jax.random.PRNGKey(20), jcfg))
    tp = _load(trec.RGLRU(cfg, "cpu"), jp, np.random.RandomState(21))
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("s", [1, 37, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_matches_jax(s, dtype):
    jcfg, cfg, jp, tp = _rglru(dtype)
    jx, tx = _x(22, 2, s, cfg.d_model, dtype=dtype)
    _close(trec.apply_rglru(tp, tx, cfg), jrec.apply_rglru(jp, jx, jcfg),
           dtype)


def test_rglru_decode_matches_jax():
    jcfg, cfg, jp, tp = _rglru("float32")
    jst = jrec.rglru_init_state(jcfg, 2)
    st = trec.rglru_init_state(cfg, 2, torch.float32, "cpu")
    xs = []
    for t in range(9):
        jx, tx = _x(30 + t, 2, cfg.d_model)
        xs.append(tx)
        jo, jst = jrec.apply_rglru_decode(jp, jx, jst, jcfg)
        to, st = trec.apply_rglru_decode(tp, tx, st, cfg)
        _close(to, jo, "float32")
        _close(st.h, jst.h, "float32")
        _close(st.conv, jst.conv, "float32")
    # the steps are the full-sequence body, token by token
    full = trec.apply_rglru(tp, torch.stack(xs, 1), cfg)
    _close(full[:, -1], np.asarray(to.numpy()), "float32")


@pytest.mark.parametrize("s", [1, 2, 3, 16, 37, 2048])
def test_linear_scan_is_the_recurrence(s):
    rng = np.random.RandomState(s)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, (2, s, 3)))
    b = torch.as_tensor(rng.randn(2, s, 3))
    h, hs = torch.zeros(2, 3, dtype=torch.float64), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    np.testing.assert_allclose(trec.linear_scan(a, b).numpy(),
                               torch.stack(hs, 1).numpy(), rtol=1e-10,
                               atol=1e-10)
