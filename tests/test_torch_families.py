"""The nine attention / MoE / RG-LRU / encoder-decoder families of
``configs/`` on the port, against the JAX package, on the CPU.

For each family's smoke config (2-3 layers, d = 64, vocab 256) the JAX
package's ``init_params`` (PRNGKey(0)) is carried over by
``repro_torch.models.from_numpy_params``, and the same seeded numpy tokens
(and, for seamless-m4t-medium, frames) go through both packages:
``forward``'s logits and aux loss, 8 teacher-forced ``decode_step``s, and
the greedy ``make_serve_step``'s ids.  Tolerances as in
tests/test_torch_models.py: logits within 1e-4 absolute in fp32
(``FP32_ATOL``); in bf16 within 0.15 (``BF16_ATOL``) with argmax agreement
>= 0.9, where the two frameworks round at other places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.models import (encode, forward, from_numpy_params,
                                init_decode_state, init_params,
                                make_serve_step, to_numpy_params)
from repro_torch.models import model as tmodel
from repro_torch.models.blocks import ATTN_BLOCKS, block_window
from repro_torch.models.config import ModelConfig

FP32_ATOL = 1e-4
BF16_ATOL = 0.15
FAMILIES = [a for a in jconfigs.arch_ids() if a != "xlstm-1.3b"]
ENC_FRAMES = 24          # encoder frames (another length than the tokens')

_PARAMS = {}


@pytest.fixture(autouse=True)
def _serving():
    """These tests serve: ``forward`` runs under ``torch.no_grad()``, as
    every serving caller runs it (under grad it records the graph a train
    step differentiates)."""
    with torch.no_grad():
        yield


def _cfgs(arch, dtype="float32", **kw):
    return (jconfigs.get_smoke_config(arch).with_overrides(dtype=dtype, **kw),
            configs.get_smoke_config(arch).with_overrides(dtype=dtype, **kw))


def _params(arch):
    """(JAX params, numpy tree, port model on the CPU), from PRNGKey(0)."""
    if arch not in _PARAMS:
        jcfg, cfg = _cfgs(arch)
        jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
        tree = jax.tree_util.tree_map(np.asarray, jp)
        _PARAMS[arch] = (jp, tree, from_numpy_params(tree, cfg,
                                                     device="cpu"))
    return _PARAMS[arch]


def _batch(cfg, seed, b, s):
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.is_enc_dec:
        batch["frames"] = rng.randn(b, ENC_FRAMES, cfg.d_model).astype(
            np.float32)
    return batch


def _states(jp, model, jcfg, cfg, batch, b, cache_len):
    """Fresh decode states in both packages (the cross K/V from the same
    frames for an encoder-decoder model)."""
    jst = jmodels.init_decode_state(jcfg, b, cache_len)
    if not cfg.is_enc_dec:
        return jst, init_decode_state(cfg, b, cache_len, device="cpu")
    jenc = jmodel.encode(jp, jnp.asarray(batch["frames"]), jcfg)
    jst = jst._replace(cross_kv=jmodel.precompute_cross_kv(jp, jenc, jcfg))
    enc = encode(model, torch.as_tensor(batch["frames"]), cfg)
    return jst, init_decode_state(cfg, b, cache_len, enc_out=enc,
                                  params=model, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_jax(arch, dtype):
    jp, _, model = _params(arch)
    jcfg, cfg = _cfgs(arch, dtype)
    batch = _batch(cfg, 0, 2, 64)
    want, jaux = jmodels.forward(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    got, aux = forward(model, {k: torch.as_tensor(v)
                               for k, v in batch.items()}, cfg)
    assert got.dtype == torch.float32 and got.shape == (2, 64,
                                                        cfg.vocab_size)
    want, got = np.asarray(want), got.numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                                   atol=1e-7)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9
    assert (float(aux) > 0) == cfg.block_pattern[0].endswith("moe")


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_routes_match_jax(arch):
    """The chunked and extent attention schedules and several MoE waves,
    forced at S = 64 (chunk 16), through the whole model in fp32."""
    jp, _, model = _params(arch)
    kw = dict(dense_attn_threshold=16, attn_chunk=16, moe_group_size=16)
    for schedule in ("masked", "extent"):
        jcfg, cfg = _cfgs(arch, attn_schedule=schedule, **kw)
        batch = _batch(cfg, 1, 2, 64)
        if cfg.is_enc_dec:                  # the chunked cross route too
            batch["frames"] = np.random.RandomState(2).randn(
                2, 64, cfg.d_model).astype(np.float32)
        want, jaux = jmodels.forward(
            jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
        got, aux = forward(model, {k: torch.as_tensor(v)
                                   for k, v in batch.items()}, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=FP32_ATOL)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_steps_match_jax(arch):
    jp, _, model = _params(arch)
    jcfg, cfg = _cfgs(arch)
    batch = _batch(cfg, 3, 3, 8)
    toks = batch["tokens"]
    jst, st = _states(jp, model, jcfg, cfg, batch, 3, 16)
    for t in range(8):
        jl, jst = jmodels.decode_step(jp, jst, jnp.asarray(toks[:, t:t + 1]),
                                      jcfg)
        tl, st = tmodel.decode_step(model, st, torch.as_tensor(
            toks[:, t:t + 1]), cfg)
        assert tl.shape == (3, 1, cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=FP32_ATOL)
    assert st.pos.tolist() == [8, 8, 8]


@pytest.mark.parametrize("mode", ["ragged", "uniform"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_serve_step_matches_jax(arch, mode):
    jp, _, model = _params(arch)
    jcfg, cfg = _cfgs(arch, decode_pos_mode=mode)
    batch = _batch(cfg, 5, 2, 6)
    prompt = batch["tokens"]
    jserve = jax.jit(jmodels.make_serve_step(jcfg))
    serve = make_serve_step(cfg)
    jst, st = _states(jp, model, jcfg, cfg, batch, 2, 32)
    jtok, tok = jnp.asarray(prompt[:, :1]), torch.as_tensor(prompt[:, :1])
    jids, ids = [], []
    for t in range(14):
        jnxt, jst = jserve(jp, jst, jtok)
        nxt, st = serve(model, st, tok)
        assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
        if t + 1 < prompt.shape[1]:                 # teacher-forced
            jtok = jnp.asarray(prompt[:, t + 1:t + 2])
            tok = torch.as_tensor(prompt[:, t + 1:t + 2])
        else:
            jtok, tok = jnxt, nxt
            jids.append(np.asarray(jnxt))
            ids.append(nxt.numpy())
    np.testing.assert_array_equal(np.concatenate(ids, 1),
                                  np.concatenate(jids, 1))
    assert st.pos.tolist() == [14, 14]


# the two properties of the reference that a teacher-forced decode does not
# reproduce, each removed by its override: seamless-m4t-medium's forward
# rotates the cross-attention queries and its decode does not; granite's
# forward drops tokens past the experts' capacity and a decode step of one
# token drops none
AGREE_OVERRIDES = {"seamless-m4t-medium": dict(rope_pct=0.0),
                   "granite-moe-3b-a800m": dict(moe_capacity_factor=8.0),
                   "mixtral-8x7b": dict(moe_capacity_factor=8.0)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_agrees_with_forward(arch):
    """Teacher-forced decode gives the prefill's logits (the port against
    itself: KV caches, the ring, the RG-LRU state, the cross K/V)."""
    _, _, model = _params(arch)
    _, cfg = _cfgs(arch, **AGREE_OVERRIDES.get(arch, {}))
    batch = _batch(cfg, 4, 2, 16)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    full, _ = forward(model, tb, cfg)
    st = init_decode_state(cfg, 2, 16, device="cpu")
    if cfg.is_enc_dec:
        st = init_decode_state(cfg, 2, 16, device="cpu",
                               enc_out=encode(model, tb["frames"], cfg),
                               params=model)
    for t in range(16):
        step, st = tmodel.decode_step(model, st, tb["tokens"][:, t:t + 1],
                                      cfg)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=0, atol=FP32_ATOL)


@pytest.mark.parametrize("arch,override", [
    ("seamless-m4t-medium", "rope_pct"),
    ("granite-moe-3b-a800m", "moe_capacity_factor")])
def test_reference_properties_are_reproduced(arch, override):
    """Without the override, forward and teacher-forced decode differ in
    the port as in the reference, and by the same logits."""
    jp, _, model = _params(arch)
    jcfg, cfg = _cfgs(arch)
    batch = _batch(cfg, 4, 2, 16)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    full, _ = forward(model, tb, cfg)
    jst, st = _states(jp, model, jcfg, cfg, batch, 2, 16)
    gap, jgap = 0.0, 0.0
    jfull, _ = jmodels.forward(jp, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, jcfg)
    for t in range(16):
        tok = batch["tokens"][:, t:t + 1]
        step, st = tmodel.decode_step(model, st, torch.as_tensor(tok), cfg)
        jstep, jst = jmodels.decode_step(jp, jst, jnp.asarray(tok), jcfg)
        np.testing.assert_allclose(step.numpy(), np.asarray(jstep), rtol=0,
                                   atol=FP32_ATOL)
        gap = max(gap, float((step[:, 0] - full[:, t]).abs().max()))
        jgap = max(jgap, float(np.abs(np.asarray(jstep)[:, 0]
                                      - np.asarray(jfull)[:, t]).max()))
    assert gap > 0.01 and abs(gap - jgap) < 1e-3


def test_mixtral_ring_cache_matches_full_cache():
    """The reference's own case (tests/test_models.py): Mixtral's SWA
    decode through the ring buffer (cache_len == window) equals the full
    cache's, on the port, from the reference's weights at PRNGKey(4)."""
    arch = "mixtral-8x7b"
    jcfg, cfg = _cfgs(arch, dtype="bfloat16")
    tree = jax.tree_util.tree_map(
        np.asarray, jmodels.init_train_state(jax.random.PRNGKey(4),
                                             jcfg).params)
    model = from_numpy_params(tree, cfg, device="cpu")
    toks = np.random.RandomState(6).randint(0, cfg.vocab_size, (1, 12))
    ring = init_decode_state(cfg, 1, cfg.window, device="cpu")
    full = init_decode_state(cfg, 1, 64, device="cpu")
    assert ring.block_states[0].k.shape[1] == cfg.window == 32
    for t in range(12):
        tok = torch.as_tensor(toks[:, t:t + 1])
        lr, ring = tmodel.decode_step(model, ring, tok, cfg)
        lf, full = tmodel.decode_step(model, full, tok, cfg)
    np.testing.assert_allclose(lr.numpy(), lf.numpy(), rtol=2e-2,
                               atol=2e-2)


def test_ring_wraps_past_the_window():
    """Past the window the ring overwrites its oldest slots, and decode
    still equals forward, whose window masks the same positions."""
    arch = "mixtral-8x7b"
    _, _, model = _params(arch)
    _, cfg = _cfgs(arch, window=8, moe_capacity_factor=8.0)
    toks = torch.as_tensor(_batch(cfg, 7, 2, 24)["tokens"])
    full, _ = forward(model, {"tokens": toks}, cfg)
    st = init_decode_state(cfg, 2, 24, device="cpu")
    assert st.block_states[0].k.shape[1] == 8
    for t in range(24):
        step, st = tmodel.decode_step(model, st, toks[:, t:t + 1], cfg)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=0, atol=FP32_ATOL)


# ---------------------------------------------------------------------------
# weights, init, structure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_converter_round_trip_is_exact(arch):
    _, tree, model = _params(arch)
    back = to_numpy_params(model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        assert flat_b[path].dtype == a.dtype
        np.testing.assert_array_equal(flat_b[path], a)
    _, cfg = _cfgs(arch)
    again = from_numpy_params(back, cfg, device="cpu")
    for (ka, a), (kb, b) in zip(model.state_dict().items(),
                                again.state_dict().items()):
        assert ka == kb and torch.equal(a, b)


def _leaf_name(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_follows_the_reference_distributions(arch):
    """Leaf by leaf: the same shape, dtype and scale (std within 15 %, the
    means within 5 standard errors), the constant leaves equal, and the reference's
    quirks: the stacked experts at 1/sqrt(E), the RG-LRU gates at
    1/sqrt(4), the router at 0.02, the conv taps at 0.5, lam a linspace."""
    _, cfg = _cfgs(arch)
    _, tree, _ = _params(arch)
    model = init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    mine = to_numpy_params(model)
    theirs = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(theirs) == len(jax.tree_util.tree_leaves(mine))
    std_trunc = 0.8796                 # std of N(0, 1) truncated to [-2, 2]
    for path, a in jax.tree_util.tree_leaves_with_path(mine):
        b = theirs[path]
        name = _leaf_name(path)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if np.all(b == b.flat[0]):
            np.testing.assert_array_equal(a, b, err_msg=name)
            continue
        if name.endswith("lam"):
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
            continue
        if a.size >= 256:
            np.testing.assert_allclose(a.std(), b.std(), rtol=0.15,
                                       err_msg=name)
            assert abs(a.mean() - b.mean()) < 5 * b.std() * (2 / a.size) \
                ** 0.5, name
        leaf = name.split("/")[-1]
        stacked = name.startswith(("units", "enc_units"))   # unit axis
        shape = a.shape[1:] if stacked else a.shape
        if leaf == "router":
            want = 0.02
        elif name.endswith("conv/w"):
            want = 0.5
        elif leaf == "embed":
            continue                         # 0.02 N(0, 1), not truncated
        else:
            want = shape[0] ** -0.5
        if a.size >= 256:
            np.testing.assert_allclose(a.std(), want * std_trunc, rtol=0.15,
                                       err_msg=name)
        assert np.abs(a).max() <= 2 * want * (1 + 1e-6), name


@pytest.mark.parametrize("arch", FAMILIES)
def test_layer_structure_matches_the_reference(arch):
    """The decoder layers, the tail (recurrentgemma's 38 = 12 x (R, R, A)
    + (R, R) at full size), the encoder and the decode state's caches."""
    cfg = configs.get_config(arch)
    types = tmodel.layer_types(cfg)
    assert len(types) == cfg.n_layers
    p = len(cfg.block_pattern)
    assert tuple(types[cfg.n_units * p:]) == cfg.tail_pattern
    if arch == "recurrentgemma-9b":
        assert cfg.n_units == 12 and cfg.tail_pattern == ("rglru", "rglru")
    scfg = configs.get_smoke_config(arch)
    _, _, model = _params(arch)
    assert [b.block_type for b in model.layers] == tmodel.layer_types(scfg)
    assert hasattr(model, "enc_layers") == scfg.is_enc_dec
    if scfg.is_enc_dec:
        assert len(model.enc_layers) == scfg.encoder_layers
        assert all(hasattr(b, "cross") and not hasattr(b.cross, "bq")
                   for b in model.layers)
    st = init_decode_state(scfg, 2, 100, device="cpu")
    for bt, state in zip(tmodel.layer_types(scfg), st.block_states):
        if bt in ATTN_BLOCKS:
            w = block_window(scfg, bt)
            assert state.k.shape == (2, min(100, w) if w else 100,
                                     scfg.n_kv_heads, scfg.head_dim)
    _, tree, _ = _params(arch)
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(tree))


def test_unknown_block_type_is_refused():
    """As the reference: the config refuses an unknown block type, and so
    does the port's block constructor."""
    from repro.models.config import ModelConfig as JConfig
    from repro_torch.models.blocks import Block
    kw = dict(name="x", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab_size=256)
    for cls in (ModelConfig, JConfig):
        with pytest.raises(ValueError, match="unknown block type"):
            cls(block_pattern=("attn", "conv"), **kw)
    with pytest.raises(ValueError, match="conv"):
        Block(ModelConfig(**kw), "conv", "cpu")
