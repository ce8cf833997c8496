"""Training on the port against the JAX package, on the CPU: the sLSTM
backward, AdamW, gradient compression, the composed train step and the
sharding policy.

* The plain sLSTM backward (``ref.slstm_sequence_backward_ref`` +
  ``slstm_param_grads``, through ``SLSTMSequence``) against ``jax.vjp`` of
  the reference's scan (``repro.kernels.ref.slstm_sequence_ref``) on random
  cotangents: dgates, dr and db within 1e-5 of each tensor's largest
  magnitude in fp32 (``VJP_TOL``: fp32 sums in another order); with bf16
  gates dr and db the same, and dgates, rounded to bf16 by both, within one
  bf16 step of the largest (2^-7 of it, ``VJP_BF16_DGATES``).  Plus
  ``gradcheck`` of ``SLSTMSequence`` in float64.
* ``apply_updates`` against ``repro.optim.adamw.apply_updates`` on the same
  numpy gradients over a tree with scanned units and a tail: all three
  schedules, clip on and off, three steps; params, m, v within 1e-6 and the
  step equal.  The reference decays a unit's norm scale ((n_units, d) in its
  tree) and not the tail's or ``final_norm``'s ((d,)), and so does the port.
* ``compress_decompress`` against the reference over two steps: the codes
  and scales equal (one scale per reference leaf), the dequantized grads
  and the error feedback within 1e-7.
* ``make_train_step`` against the reference's, three steps on the same
  state and batch: loss and grad norm within 1e-4 relative; after step 1
  every parameter within 2·lr (AdamW's first step is ~sign(g)·lr, so an
  element whose gradient is ~0 may move the other way) and 99 % of them
  within 1e-5.
* ``ShardingPolicy``'s specs, decisions and replicated report equal the
  reference's on every family's train-state tree at (data, model) (1, 1),
  (2, 2), (4, 2), (8, 1), with its three flags, and the batch and decode
  state specs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.distributed import sharding as jsharding
from repro.kernels import ref as jref
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch import configs
from repro_torch.distributed.sharding import (ShardingPolicy,
                                              make_train_shardings,
                                              placements)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.slstm import SLSTMSequence
from repro_torch.models import (decay_mask, from_numpy_params, leaf_groups,
                                make_train_step)
from repro_torch.models.convert import _from_tree, _source, _to_tree
from repro_torch.models.model import Model
from repro_torch.optim import adamw, compression

VJP_TOL = 1e-5
VJP_BF16_DGATES = 2.0 ** -7
OPT_TOL = 1e-6
EF_TOL = 1e-7
STEP_RTOL = 1e-4


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


# ---------------------------------------------------------------------------
# the sLSTM backward
# ---------------------------------------------------------------------------

def _slstm_case(seed, b, s, d, h):
    rng = np.random.RandomState(seed)
    blk = d // h
    gates = rng.randn(b, s, 4 * d).astype(np.float32)
    r = (rng.randn(4, h, blk, blk) / np.sqrt(blk)).astype(np.float32)
    bias = (0.5 * rng.randn(4 * d)).astype(np.float32)
    bias[d:2 * d] += 3.0
    dy = rng.randn(b, s, d).astype(np.float32)
    return gates, r, bias, dy


def _assert_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, (
        what, np.abs(got - want).max(), scale)


@pytest.mark.parametrize("b,s,d,h", [(2, 9, 16, 2), (3, 24, 32, 4),
                                     (1, 40, 20, 4), (4, 16, 64, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_backward_matches_jax_vjp(b, s, d, h, dtype):
    gates, r, bias, dy = _slstm_case(b * s + d, b, s, d, h)
    jdt = getattr(jnp, dtype)
    g_j = jnp.asarray(gates).astype(jdt)
    h_j, vjp = jax.vjp(lambda g, rr, bb: jref.slstm_sequence_ref(
        g, rr, bb, h), g_j, jnp.asarray(r), jnp.asarray(bias))
    want = vjp(jnp.asarray(dy).astype(jdt))

    tdt = getattr(torch, dtype)
    ins = [torch.as_tensor(gates).to(tdt).requires_grad_(),
           torch.as_tensor(r).requires_grad_(),
           torch.as_tensor(bias).requires_grad_()]
    out = ops.slstm_sequence(*ins, n_heads=h)
    assert out.dtype == tdt
    _assert_close(out.float().detach().numpy(),
                  np.asarray(h_j.astype(jnp.float32)), 1e-6 if
                  dtype == "float32" else 2.0 ** -8, "h")
    out.backward(torch.as_tensor(dy).to(tdt))
    got = [t.grad for t in ins]
    assert got[0].dtype == tdt and got[1].dtype == got[2].dtype \
        == torch.float32
    _assert_close(got[0].float().numpy(), np.asarray(want[0].astype(
        jnp.float32)), VJP_TOL if dtype == "float32" else VJP_BF16_DGATES,
        "dgates")
    _assert_close(got[1].numpy(), np.asarray(want[1]), VJP_TOL, "dr")
    _assert_close(got[2].numpy(), np.asarray(want[2]), VJP_TOL, "db")


def test_slstm_sequence_gradcheck_float64():
    gates, r, bias, _ = _slstm_case(0, 2, 5, 8, 2)
    ins = [torch.as_tensor(x).double().requires_grad_()
           for x in (gates, r, bias)]
    assert torch.autograd.gradcheck(
        lambda g, rr, bb: SLSTMSequence.apply(g, rr, bb, 2, True), ins)


def test_slstm_saved_forward_is_the_serving_one():
    gates, r, bias, _ = _slstm_case(1, 3, 12, 32, 4)
    g, rr, bb = map(torch.as_tensor, (gates, r, bias))
    h, saved = ref.slstm_sequence_save_ref(g, rr, bb, 4)
    assert torch.equal(h, ref.slstm_sequence_ref(g, rr, bb, 4))
    assert saved.shape == (8, 3, 12, 32)
    assert torch.equal(saved[ref.SLSTM_SAVED.index("h")], h)
    # without grad the serving path records nothing
    with torch.no_grad():
        out = ops.slstm_sequence(g, rr.requires_grad_(), bb, n_heads=4)
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# AdamW and compression against the reference, on the same numpy tree
# ---------------------------------------------------------------------------

def _tree_case():
    """recurrentgemma's smoke config at 4 layers: one scanned unit of
    (rglru, rglru, local_attn) and a tail block (rglru)."""
    jcfg = jconfigs.get_smoke_config("recurrentgemma-9b").with_overrides(
        dtype="float32", n_layers=4)
    cfg = configs.get_smoke_config("recurrentgemma-9b").with_overrides(
        dtype="float32", n_layers=4)
    assert jcfg.tail_pattern == ("rglru",)
    tree = jax.tree_util.tree_map(
        np.asarray, jmodels.init_params(jax.random.PRNGKey(0), jcfg))
    return cfg, tree


def _grads_like(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.randn(*p.shape) * (1 + rng.rand())).astype(np.float32),
        tree)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("clip", [1.0, None])
def test_apply_updates_matches_the_reference(schedule, clip):
    cfg, tree = _tree_case()
    ocfg = dict(lr=1e-2, schedule=schedule, warmup_steps=2, total_steps=5,
                grad_clip_norm=clip)
    jcfg, tcfg = jadamw.AdamWConfig(**ocfg), adamw.AdamWConfig(**ocfg)
    model = from_numpy_params(tree, cfg, device="cpu")
    names = dict(model.named_parameters())
    decay = decay_mask(model)
    jp, jst = jax.tree_util.tree_map(jnp.asarray, tree), jadamw.init(tree)
    params = {k: p.detach().clone() for k, p in names.items()}
    st = adamw.init(params)
    for step in range(3):
        g_np = _grads_like(tree, step)
        jp, jst, jn = jadamw.apply_updates(
            jp, jax.tree_util.tree_map(jnp.asarray, g_np), jst, jcfg)
        params, st, tn = adamw.apply_updates(
            params, _from_tree(g_np, names, cfg), st, tcfg, decay=decay)
        assert abs(tn.item() - float(jn)) <= 1e-6 * float(jn)
        assert int(st.step) == int(jst.step) == step + 1
        for got, want in ((params, jp), (st.m, jst.m), (st.v, jst.v)):
            g_tree = dict(_leaves(_to_tree(got, cfg)))
            for path, w in _leaves(jax.tree_util.tree_map(np.asarray, want)):
                assert np.abs(g_tree[path] - w).max() <= OPT_TOL, path


def test_weight_decay_follows_the_reference_leaf():
    """A unit's norm scale is (n_units, d) in the reference's tree, so it is
    decayed; the tail's and final_norm's are (d,) and are not.  With zero
    gradients only decay moves a parameter, in both packages."""
    cfg, tree = _tree_case()
    model = from_numpy_params(tree, cfg, device="cpu")
    decay = decay_mask(model)
    unit_norm, tail_norm = "layers.0.norm1.scale", "layers.3.norm1.scale"
    assert decay[unit_norm] and not decay[tail_norm]
    assert not decay["final_norm.scale"] and decay["embed"]
    ocfg = dict(lr=1e-1, warmup_steps=0, schedule="constant")
    zeros = jax.tree_util.tree_map(np.zeros_like, tree)
    jp, _, _ = jadamw.apply_updates(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jax.tree_util.tree_map(jnp.asarray, zeros), jadamw.init(tree),
        jadamw.AdamWConfig(**ocfg))
    before = dict(model.named_parameters())
    params = {k: p.detach().clone() for k, p in before.items()}
    new, _, _ = adamw.apply_updates(params, {}, adamw.init(params),
                                    adamw.AdamWConfig(**ocfg), decay=decay)
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jp)))
    assert np.allclose(want["units/0/norm1/scale"], 0.99)
    assert np.array_equal(want["tail/0/norm1/scale"], tree["tail"]["0"][
        "norm1"]["scale"])
    assert np.array_equal(want["final_norm/scale"],
                          tree["final_norm"]["scale"])
    assert torch.allclose(new[unit_norm], torch.full_like(
        new[unit_norm], 0.99))
    assert torch.equal(new[tail_norm], before[tail_norm])
    assert torch.equal(new["final_norm.scale"], before["final_norm.scale"])


def test_schedules_match_the_reference():
    for schedule in ("cosine", "linear", "constant"):
        kw = dict(lr=3e-4, schedule=schedule, warmup_steps=10,
                  total_steps=50, min_lr_ratio=0.1)
        jf = jadamw.make_schedule(jadamw.AdamWConfig(**kw))
        tf = adamw.make_schedule(adamw.AdamWConfig(**kw))
        for step in (0, 1, 5, 10, 11, 30, 50, 80):
            want = float(jf(jnp.asarray(step, jnp.int32)))
            got = tf(torch.tensor(step, dtype=torch.int32)).item()
            assert abs(got - want) <= 1e-6 * kw["lr"], (schedule, step)


def test_compress_decompress_matches_the_reference():
    cfg, tree = _tree_case()
    model = from_numpy_params(tree, cfg, device="cpu")
    names = dict(model.named_parameters())
    leaves = leaf_groups(model)
    jef = jcomp.init_error_feedback(tree)
    ef = compression.init_error_feedback(names)
    for step in range(2):
        g_np = _grads_like(tree, 10 + step)
        grads = _from_tree(g_np, names, cfg)
        # codes and scales: the reference's per leaf, the port's per group
        targets = {k: grads[k] + ef[k] for k in grads}
        jtargets = jax.tree_util.tree_map(
            lambda g, e: jnp.asarray(g) + e, g_np, jef)
        for path, jt in _leaves(jtargets):
            jc, js = jcomp.quantize_leaf(jt)
            members = [k for k, leaf in leaves.items() if leaf == path]
            scale = compression.leaf_scale(torch.stack(
                [targets[k].abs().max() for k in members]).max())
            codes = _to_tree({k: compression.quantize_leaf(
                targets[k], scale)[0] for k in members}, cfg)
            assert scale.item() == float(js), path
            assert np.array_equal(dict(_leaves(codes))[path],
                                  np.asarray(jc)), path
        jdeq, jef = jcomp.compress_decompress(
            jax.tree_util.tree_map(jnp.asarray, g_np), jef)
        deq, ef = compression.compress_decompress(grads, ef, leaves=leaves)
        for got, want in ((deq, jdeq), (ef, jef)):
            g_tree = dict(_leaves(_to_tree(got, cfg)))
            for path, w in _leaves(jax.tree_util.tree_map(np.asarray, want)):
                assert np.abs(g_tree[path] - w).max() <= EF_TOL, path
    assert compression.compression_ratio(names, leaves=leaves) == \
        pytest.approx(jcomp.compression_ratio(tree), rel=1e-12)


# ---------------------------------------------------------------------------
# the composed train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "xlstm-1.3b",
                                  "granite-moe-3b-a800m"])
def test_train_step_matches_the_reference(arch):
    from repro.models.steps import TrainState as JTrainState
    from repro.models.steps import make_train_step as j_make_train_step
    from repro_torch.models.steps import TrainState

    jcfg = jconfigs.get_smoke_config(arch).with_overrides(dtype="float32")
    cfg = configs.get_smoke_config(arch).with_overrides(dtype="float32")
    lr = 1e-3
    ocfg = dict(lr=lr, warmup_steps=1, total_steps=10)
    jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    model = from_numpy_params(tree, cfg, device="cpu")
    state = TrainState(model=model,
                       opt=adamw.init(dict(model.named_parameters())))
    jstate = JTrainState(params=jp, opt=jadamw.init(jp))
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "segment_ids": np.ones((2, 16), np.int32)}
    jstep = jax.jit(j_make_train_step(jcfg, jadamw.AdamWConfig(**ocfg)))
    step = make_train_step(cfg, adamw.AdamWConfig(**ocfg))
    for i in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.as_tensor(v)
                                for k, v in batch.items()})
        for key in ("loss", "grad_norm", "ce"):
            want = float(jm[key])
            assert abs(m[key].item() - want) <= STEP_RTOL * abs(want), (
                i, key, m[key].item(), want)
        assert m["step"].item() == float(jm["step"]) == i + 1
        if i == 0:
            got = dict(_leaves(_to_tree(dict(model.named_parameters()),
                                        cfg)))
            diff = np.concatenate([
                np.abs(got[path] - np.asarray(w)).ravel()
                for path, w in _leaves(jax.tree_util.tree_map(
                    np.asarray, jstate.params))])
            assert diff.max() <= 2 * lr * 1.001, diff.max()
            assert (diff <= 1e-5).mean() >= 0.99, (diff <= 1e-5).mean()


# ---------------------------------------------------------------------------
# the sharding policy
# ---------------------------------------------------------------------------

class _Mesh:
    """Both packages' view of a (data, model) mesh: the reference reads
    ``axis_names`` and ``devices.shape``, the port ``mesh_dim_names`` and
    ``mesh.shape``."""

    def __init__(self, names, shape):
        self.axis_names = self.mesh_dim_names = names
        self.devices = self.mesh = np.zeros(shape)


def _shape_tree(cfg):
    """The port's train state's shapes in the reference's layout, from a
    model on the meta device (the full configs, nothing allocated)."""
    model = Model(cfg, "meta")
    tree = {}
    stacks = {}
    for key, p in model.named_parameters():
        path, u = _source(key, cfg)
        if u is None:
            stacks[path] = tuple(p.shape)
        else:
            stacks.setdefault(path, [0, tuple(p.shape)])[0] += 1
    for path, v in stacks.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v if isinstance(v, tuple) else (v[0],) + v[1]
    return {"params": tree, "opt": {"step": (), "m": tree, "v": tree}}


_TREES = {}


def _trees(arch):
    """(the reference's abstract train state, the port's shape tree) of a
    full config, built once an arch."""
    if arch not in _TREES:
        from repro.models.steps import abstract_train_state
        _TREES[arch] = (abstract_train_state(jconfigs.get_config(arch)),
                        _shape_tree(configs.get_config(arch)))
    return _TREES[arch]


@pytest.mark.parametrize("arch", jconfigs.arch_ids())
@pytest.mark.parametrize("sizes", [(1, 1), (2, 2), (4, 2), (8, 1)])
@pytest.mark.parametrize("flags", [{}, {"dp_only": True},
                                   {"head_proj_model_only": True}])
def test_sharding_specs_match_the_reference(arch, sizes, flags):
    mesh = _Mesh(("data", "model"), sizes)
    jpol = jsharding.ShardingPolicy(mesh, **flags)
    pol = ShardingPolicy(mesh, **flags)
    jstate, shapes = _trees(arch)
    jspecs = jpol.spec_tree(jstate)
    specs = pol.spec_tree(shapes)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = {jsharding._path_str(p): tuple(spec) for p, spec in flat}
    got = dict(_leaves(specs))
    assert got == want
    assert sorted((p, tuple(s), tuple(sp)) for p, s, sp in jpol.decisions) \
        == sorted(pol.decisions)
    assert pol.replicated_report() == jpol.replicated_report()
    assert pol.n_batch_shards == jpol.n_batch_shards
    for shape in [(8, 16), (1, 16), (6,), ()]:
        assert pol.batch_spec(shape) == tuple(jpol.batch_spec(shape))


@pytest.mark.parametrize("sizes", [(2, 2), (4, 2), (8, 1)])
@pytest.mark.parametrize("seq", [False, True])
def test_serve_state_specs_match_the_reference(sizes, seq):
    mesh = _Mesh(("data", "model"), sizes)
    jpol = jsharding.ShardingPolicy(mesh, shard_cache_seq=seq)
    pol = ShardingPolicy(mesh, shard_cache_seq=seq)
    for path, shape in [("block_states/units/0/k", (3, 8, 64, 2, 16)),
                        ("block_states/units/0/v", (3, 8, 64, 2, 16)),
                        ("block_states/tail/0/k", (8, 64, 2, 16)),
                        ("block_states/units/1/c", (3, 8, 64)),
                        ("cross_kv/0", (3, 8, 24, 2, 16)),
                        ("pos", (8,)), ("pos", (3,)), ("x", ())]:
        assert pol.serve_state_spec(path, shape) == tuple(
            jpol.serve_state_spec(path, shape)), path


def test_placements_and_train_shardings():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Mesh(("data", "model"), (4, 2))
    assert placements(("model", "data"), mesh) == [Shard(1), Shard(0)]
    assert placements((("data", "model"), None), mesh) == [Shard(0), Shard(0)]
    assert placements(("data", None), mesh) == [Shard(0), Replicate()]
    assert placements((None, None), mesh) == [Replicate(), Replicate()]
    pol = ShardingPolicy(mesh)
    state = {"params": {"embed": (256, 64), "units": {"0": {"mlp": {
        "wd": (2, 128, 64)}}}}}
    st, bt = make_train_shardings(pol, state, {"tokens": (8, 16)})
    assert st["params"]["embed"] == [Shard(1), Shard(0)]
    assert st["params"]["units"]["0"]["mlp"]["wd"] == [Shard(2), Shard(1)]
    assert bt["tokens"] == [Shard(0), Replicate()]
