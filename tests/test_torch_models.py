"""The port's xLSTM serving path against the JAX package, on the CPU.

The same numpy inputs and the same weights (the JAX package's
``init_params``, carried over by ``repro_torch.models.from_numpy_params``)
go through both packages at the smoke width of xlstm-1.3b (4 layers,
d = 64, 2 heads, vocab 256).  B8's plain version is held to the JAX
package's oracle and to its Pallas kernel in interpret mode at the JAX
package's own tolerance (tests/test_kernels.py: rtol = atol = 3e-5); the
model to 1e-4 in fp32, and to 0.15 with argmax agreement >= 0.9 in bf16,
where the two frameworks round at other places.  The CUDA kernel itself
runs only on a card: tests/test_torch_cuda.py.  The other nine families
are tests/test_torch_families.py, their layers tests/test_torch_attention.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.data import synthetic as jsynth
from repro.kernels import ref as jref
from repro.kernels.slstm import slstm_sequence_kernel
from repro.models import recurrent as jrec
from repro_torch import configs
from repro_torch.data import synthetic
from repro_torch.kernels import ops, ref
from repro_torch.kernels import slstm as slstm_mod
from repro_torch.models import (from_numpy_params, init_decode_state,
                                init_params, make_serve_step,
                                to_numpy_params)
from repro_torch.models import model as tmodel
from repro_torch.models import recurrent as trec

ARCH = "xlstm-1.3b"
SLSTM_TOL = dict(rtol=3e-5, atol=3e-5)
FP32_ATOL = 1e-4
BF16_ATOL = 0.15


def _cfgs(dtype):
    return (jconfigs.get_smoke_config(ARCH).with_overrides(dtype=dtype),
            configs.get_smoke_config(ARCH).with_overrides(dtype=dtype))


_PARAMS = {}


@pytest.fixture(autouse=True)
def _serving():
    """These tests serve: ``forward`` runs under ``torch.no_grad()``, as
    every serving caller runs it (under grad it records the graph a train
    step differentiates)."""
    with torch.no_grad():
        yield


def _params(dtype):
    """(JAX params, numpy tree, port model on the CPU), from PRNGKey(0)."""
    if dtype not in _PARAMS:
        jcfg, cfg = _cfgs(dtype)
        jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
        tree = jax.tree_util.tree_map(np.asarray, jp)
        _PARAMS[dtype] = (jp, tree, from_numpy_params(tree, cfg,
                                                      device="cpu"))
    return _PARAMS[dtype]


def _tokens(seed, b, s):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# B8: the plain version
# ---------------------------------------------------------------------------

def _slstm_inputs(seed, b, s, d, h, r_scale=0.3):
    rng = np.random.RandomState(seed)
    blk = d // h
    gates = rng.randn(b, s, 4 * d).astype(np.float32)
    r = (r_scale * rng.randn(4, h, blk, blk)).astype(np.float32)
    bias = rng.randn(4 * d).astype(np.float32)
    return gates, r, bias


# R = 0.3 N(0, 1) as the JAX package's kernel tests; at xlstm-1.3b's full
# head width (blk = 512) the model's own scale, 1 / sqrt(blk)
@pytest.mark.parametrize("b,s,d,h,chunk,r_scale", [
    (2, 64, 32, 4, 16, 0.3),
    (1, 32, 16, 2, 32, 0.3),
    (3, 96, 64, 8, 24, 0.3),
    (2, 8, 2048, 4, 8, 512 ** -0.5),
])
def test_slstm_ref_matches_jax_ref_and_pallas(b, s, d, h, chunk, r_scale):
    gates, r, bias = _slstm_inputs(b + s, b, s, d, h, r_scale)
    # the random R is not symmetric in (k, l): a swapped layout would show
    assert not np.allclose(r, r.transpose(0, 1, 3, 2))
    got = ref.slstm_sequence_ref(torch.as_tensor(gates), torch.as_tensor(r),
                                 torch.as_tensor(bias), n_heads=h).numpy()
    want = jref.slstm_sequence_ref(jnp.asarray(gates), jnp.asarray(r),
                                   jnp.asarray(bias), n_heads=h)
    pallas = slstm_sequence_kernel(jnp.asarray(gates), jnp.asarray(r),
                                   jnp.asarray(bias), n_heads=h, chunk=chunk,
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **SLSTM_TOL)
    np.testing.assert_allclose(got, np.asarray(pallas), **SLSTM_TOL)
    swapped = ref.slstm_sequence_ref(
        torch.as_tensor(gates), torch.as_tensor(r).transpose(2, 3),
        torch.as_tensor(bias), n_heads=h).numpy()
    assert np.abs(swapped - got).max() > 1e-3


def test_slstm_ref_matches_model_cell():
    """The plain version is the model's cell stepped over the sequence,
    started from the JAX package's initial state (m = -1e30)."""
    jcfg, _ = _cfgs("float32")
    p = jrec.init_slstm(jax.random.PRNGKey(0), jcfg)
    d, h = jcfg.d_model, jcfg.n_heads
    gates = np.random.RandomState(3).randn(2, 24, 4 * d).astype(np.float32)
    state = jrec.slstm_init_state(jcfg, 2)
    hs = []
    for t in range(24):
        hh, state = jrec._slstm_cell(p, jnp.asarray(gates[:, t]), state, h)
        hs.append(np.asarray(hh))
    got = ref.slstm_sequence_ref(torch.as_tensor(gates),
                                 torch.as_tensor(np.array(p["r"])),
                                 torch.as_tensor(np.array(p["b"])), h)
    np.testing.assert_allclose(got.numpy(), np.stack(hs, axis=1),
                               **SLSTM_TOL)


def test_slstm_dispatch_and_dtypes():
    """CPU tensors take the plain version (no launch); bf16 gates give bf16
    h, the fp32 result rounded to nearest; the kernel's wrapper refuses CPU
    tensors and a d that is not a multiple of the heads."""
    gates, r, bias = _slstm_inputs(5, 2, 9, 16, 4)
    g, rt, bt = map(torch.as_tensor, (gates, r, bias))
    before = slstm_mod.launches
    got = ops.slstm_sequence(g, rt, bt, n_heads=4)
    assert torch.equal(got, ref.slstm_sequence_ref(g, rt, bt, 4))
    got16 = ops.slstm_sequence(g.bfloat16(), rt, bt, n_heads=4)
    assert got16.dtype == torch.bfloat16
    want16 = ref.slstm_sequence_ref(g.bfloat16().float(), rt, bt, 4)
    assert torch.equal(got16, want16.bfloat16())
    assert slstm_mod.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        slstm_mod.slstm_sequence(g, rt, bt, n_heads=4)
    with pytest.raises(ValueError, match="multiple of n_heads"):
        slstm_mod.slstm_sequence(g, rt, bt, n_heads=3)


# ---------------------------------------------------------------------------
# blocks, model, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block,layer", [("mlstm", 0), ("slstm", 1)])
def test_block_bodies_match_jax(block, layer):
    jp, _, model = _params("float32")
    jcfg, cfg = _cfgs("float32")
    x = np.random.RandomState(1).randn(2, 32, jcfg.d_model).astype(
        np.float32)
    jpar = jax.tree_util.tree_map(lambda a: a[layer // 2],
                                  jp["units"][str(layer % 2)][block])
    mod = getattr(model.layers[layer], block)
    if block == "mlstm":
        want = jrec.apply_mlstm(jpar, jnp.asarray(x), jcfg, chunk=8)
        got = trec.apply_mlstm(mod, torch.as_tensor(x), cfg, chunk=8)
    else:
        want = jrec.apply_slstm(jpar, jnp.asarray(x), jcfg)
        got = trec.apply_slstm(mod, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=FP32_ATOL)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(norm_type, dtype):
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    jcfg, cfg = (c.with_overrides(norm_type=norm_type) for c in _cfgs(dtype))
    rng = np.random.RandomState(6)
    x = (3 * rng.randn(2, 5, 64) + 1).astype(np.float32)
    p = tlayers.init_norm(cfg, "cpu")
    jp = jlayers.init_norm(jcfg)
    with torch.no_grad():
        for k, v in p.named_parameters():
            v.copy_(torch.as_tensor(rng.randn(*v.shape).astype(np.float32)))
            jp[k] = jnp.asarray(v.numpy())
    got = tlayers.apply_norm(p, torch.as_tensor(x).to(cfg.activation_dtype),
                             cfg)
    want = jlayers.apply_norm(jp, jnp.asarray(x).astype(jcfg.dtype), jcfg)
    assert got.dtype == cfg.activation_dtype
    tol = FP32_ATOL if dtype == "float32" else 0.05
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_mlstm_chunk_must_divide_the_sequence():
    _, _, model = _params("float32")
    _, cfg = _cfgs("float32")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        trec.apply_mlstm(model.layers[0].mlstm, torch.zeros(1, 12, 64), cfg,
                         chunk=8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    jp, _, model = _params(dtype)
    jcfg, cfg = _cfgs(dtype)
    toks = _tokens(0, 2, 64)
    want, _ = jmodels.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = tmodel.forward(model, {"tokens": torch.as_tensor(toks)}, cfg)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    got = got.numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9
    # the module's own call is the same function
    same, _ = model(torch.as_tensor(toks))
    np.testing.assert_array_equal(same.numpy(), got)


def test_decode_steps_match_jax():
    jp, _, model = _params("float32")
    jcfg, cfg = _cfgs("float32")
    toks = _tokens(2, 3, 8)
    jst = jmodels.init_decode_state(jcfg, 3, 16)
    st = init_decode_state(cfg, 3, 16, device="cpu")
    for t in range(8):
        jl, jst = jmodels.decode_step(jp, jst, jnp.asarray(toks[:, t:t + 1]),
                                      jcfg)
        tl, st = tmodel.decode_step(model, st, torch.as_tensor(
            toks[:, t:t + 1]), cfg)
        assert tl.shape == (3, 1, cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=FP32_ATOL)
    assert st.pos.tolist() == [8, 8, 8]


def test_decode_agrees_with_forward():
    """Teacher-forced decode gives the prefill's logits (the port against
    itself: the chunkwise mLSTM and the sLSTM sequence against their
    one-step forms)."""
    _, _, model = _params("float32")
    _, cfg = _cfgs("float32")
    toks = torch.as_tensor(_tokens(4, 2, 16))
    full, _ = tmodel.forward(model, {"tokens": toks}, cfg)
    st = init_decode_state(cfg, 2, 16, device="cpu")
    for t in range(16):
        step, st = tmodel.decode_step(model, st, toks[:, t:t + 1], cfg)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=0, atol=FP32_ATOL)


def test_greedy_serve_step_matches_jax():
    jp, _, model = _params("float32")
    jcfg, cfg = _cfgs("float32")
    prompt = _tokens(5, 2, 6)
    jserve = jax.jit(jmodels.make_serve_step(jcfg))
    serve = make_serve_step(cfg)
    jst = jmodels.init_decode_state(jcfg, 2, 32)
    st = init_decode_state(cfg, 2, 32, device="cpu")
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


def test_sampled_serve_step_needs_a_generator():
    _, _, model = _params("float32")
    _, cfg = _cfgs("float32")
    with pytest.raises(ValueError, match="Generator"):
        make_serve_step(cfg, greedy=False)
    draws = []
    for _ in range(2):
        serve = make_serve_step(cfg, greedy=False, temperature=0.7,
                                generator=torch.Generator().manual_seed(3))
        st = init_decode_state(cfg, 4, 8, device="cpu")
        tok = torch.zeros((4, 1), dtype=torch.int32)
        out = []
        for _ in range(5):
            tok, st = serve(model, st, tok)
            out.append(tok)
        draws.append(torch.cat(out, 1))
    assert torch.equal(draws[0], draws[1])
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# weights, configs, entry points
# ---------------------------------------------------------------------------

def test_converter_round_trip_is_exact():
    _, tree, model = _params("float32")
    back = to_numpy_params(model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        assert flat_b[path].dtype == a.dtype
        np.testing.assert_array_equal(flat_b[path], a)
    _, cfg = _cfgs("float32")
    again = from_numpy_params(back, cfg, device="cpu")
    for (ka, a), (kb, b) in zip(model.state_dict().items(),
                                again.state_dict().items()):
        assert ka == kb and torch.equal(a, b)
    bad = dict(back, extra=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="extra"):
        from_numpy_params(bad, cfg, device="cpu")


def test_init_params_follows_the_reference_distributions():
    _, cfg = _cfgs("float32")
    _, tree, _ = _params("float32")
    model = init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    mine = to_numpy_params(model)
    theirs = dict(jax.tree_util.tree_leaves_with_path(tree))
    for path, a in jax.tree_util.tree_leaves_with_path(mine):
        b = theirs[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        # the same scale: the largest magnitude within a third, and the
        # constant leaves (norm scales, gate biases) equal
        np.testing.assert_allclose(np.abs(a).max(), np.abs(b).max(),
                                   rtol=0.35, err_msg=str(path))
        if np.all(b == b.flat[0]):
            np.testing.assert_array_equal(a, b)
    again = init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", jconfigs.arch_ids())
def test_configs_match_the_reference(arch):
    assert configs.arch_ids() == jconfigs.arch_ids()
    for get_t, get_j in ((configs.get_config, jconfigs.get_config),
                         (configs.get_smoke_config,
                          jconfigs.get_smoke_config)):
        mine, theirs = get_t(arch), get_j(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_count() == theirs.param_count()
        assert mine.active_param_count() == theirs.active_param_count()
        assert (mine.n_units, mine.tail_pattern) == (theirs.n_units,
                                                     theirs.tail_pattern)
        assert mine.activation_dtype == getattr(torch, theirs.dtype)


def test_db_config_matches_the_reference():
    from repro.configs import quantixar_db as jdb
    from repro_torch.configs import quantixar_db as tdb
    assert tdb.CONFIG == tdb.DBConfig() and \
        dataclasses.asdict(tdb.CONFIG) == dataclasses.asdict(jdb.CONFIG)
    assert dataclasses.asdict(tdb.SMOKE) == dataclasses.asdict(jdb.SMOKE)


@pytest.mark.parametrize("arch", [ARCH, "qwen2-1.5b",
                                  "seamless-m4t-medium"])
def test_entry_points_default_to_the_card(monkeypatch, arch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke_config(arch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_decode_state(cfg, 1, 8)
    tree = to_numpy_params(init_params(cfg, generator=torch.Generator(),
                                       device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_numpy_params(tree, cfg)


def test_lm_token_streams_match_the_reference():
    a = synthetic.zipf_tokens(np.random.RandomState(0), (8, 2048), 50304)
    b = jsynth.zipf_tokens(np.random.RandomState(0), (8, 2048), 50304)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.int32 and a.min() >= 0 and a.max() < 50304
    mine = synthetic.lm_batches(1000, 2, 16, seed=3)
    theirs = jsynth.lm_batches(1000, 2, 16, seed=3)
    for _ in range(3):
        x, y = next(mine), next(theirs)
        for f in ("tokens", "targets", "segment_ids"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
