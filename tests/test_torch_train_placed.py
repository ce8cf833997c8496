"""The port's placed train state (``repro_torch.distributed.sharding.
Placement``, the only path of ``launch.train.train``) on the CPU.

* Each parameter's placements, for all ten families at their published
  sizes on (2, 2), (4, 1), (1, 4) and (pod 2, data 2, model 2) meshes, are
  ``placements`` of the reference policy's spec of the reference leaf it
  belongs to (``repro.distributed.sharding.ShardingPolicy.spec_tree`` of the
  reference's abstract train state), less the stacked unit dim; the
  decision log and the replicated report are the reference's.  These run on
  meta tensors in this process: the policy reads only axis names and sizes.
* gloo rank processes (a file store, a timeout on every subprocess), on
  meshes (2, 2) and (4, 1) of 4 ranks and (1, 2) of 2 ranks (and xlstm and
  qwen3 on (pod 2, data 2, model 2) of 8 ranks), train the smoke
  configs of xlstm, qwen2, granite-moe and seamless (encoder-decoder), and
  where ``model`` > 1 qwen3 (QK norms), in fp32 for 2 steps through
  ``launch.train.train`` (where ``model`` > 1 the attention families'
  attention and dense MLP run tensor-parallel; their blocks are counted).  Losses and grad norms
  equal one process's within ``DP_TOL`` = 1e-5 relative and every parameter
  (gathered whole) within 1e-5 absolute.  With ``grad_compress`` the two
  runs' int8 codes are compared one by one (``_assert_compressed``): every
  parameter element whose codes matched at every step within 1e-5, one
  whose code flipped on a rounding boundary within 2·lr, the flips bounded
  (``MAX_CODE_FLIPS``); the losses within 1e-5 and each step's grad norm
  within 1e-5, or 1e-4 at a step where a code flipped (the norm is the
  dequantized gradient's).  The learning rate is ``train``'s default, 3e-4: at
  5e-3 AdamW's first update g / (|g| + eps) turns the last-bit difference
  of a near-zero gradient (another summation order over the batch) into up
  to 5.5e-5 on xlstm's sLSTM bias.
* The placed init is bit-equal to the world-1 init; each rank holds
  1 / (the product of its spec's axis sizes) of every parameter, m and v,
  and the whole of every replicated one; with ``bf16_weight_gather`` a
  (2, 2) run in bf16 equals one process in bf16 (losses within 2e-3
  relative, grad norms 1e-2; every parameter within 4·lr, the most two
  AdamW steps of |m̂ / √v̂| <= 1 can part two runs by, and 99 % of all
  their elements within 1e-5: bf16 gradients sum in another order over
  two halves of the batch and two model slices, and a near-zero one can
  change sign).
* Checkpoints across meshes: a generation written by a (2, 2) run restores
  in a world-1 run of the port (equal parameters) and through the
  reference's ``_unflatten_state`` (equal leaves); a reference generation
  restores into a (2, 2) run (each leaf gathered back equal); a (2, 2) run
  killed by ``simulate_failure_at`` resumes at the saved step and ends equal
  to one process doing the same.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.checkpoint import CheckpointStore as JCheckpointStore
from repro.distributed import sharding as jsharding
from repro.launch.train import _flatten_state as j_flatten_state
from repro.launch.train import _unflatten_state as j_unflatten_state
from repro.models.steps import init_train_state as j_init_train_state
from repro_torch import configs
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import (ShardingPolicy,
                                              make_train_shardings,
                                              placements)
from repro_torch.launch.train import train
from repro_torch.models import Model
from repro_torch.models.convert import (placement, reference_slot,
                                        to_numpy_params, train_state_shapes,
                                        train_state_to_numpy)

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
DP_TOL = 1e-5
LR = 3e-4
LOSS_RTOL_BF16, GNORM_RTOL_BF16 = 2e-3, 1e-2
# With grad_compress: the share of all elements whose int8 code may differ
# from one process's at a step (a target on a rounding boundary, summed in
# another order; measured on these meshes: none at step 1, at most 6 of
# seamless's 198,912 at step 2), not counting a leaf whose largest |target|
# is below NOISE_REACH: seamless's zero frames make those of its cross
# attention's and its encoder attention's wq / wk and of cross_norm zero at
# step 1 and rounding noise at step 2 (1e-16 to 6e-9, against 0.02-0.2 for
# its other attention weights), which int8 at the leaf's own scale turns
# into arbitrary codes (20,906 and 20,990 of them).  A step whose codes
# differ anywhere holds its grad norm within COMPRESS_FLIP_RTOL (measured:
# 1.3e-5 at seamless's step 2 on (2, 2)).
MAX_CODE_FLIPS = 1e-4
NOISE_REACH = 1e-6
COMPRESS_FLIP_RTOL = 1e-4
ARCHS = ("xlstm-1.3b", "qwen2-1.5b", "granite-moe-3b-a800m",
         "seamless-m4t-medium")
# qwen3's QK norms: whole tensors a tensor-parallel attention applies to its
# own heads (their gradients summed over ``model``); on the meshes with
# model > 1
QK_NORM_ARCHS = ("qwen3-4b",)
MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x2": (1, 2),
          "pod2x2x2": (2, 2, 2)}
# the pod mesh (8 ranks; the batch over pod x data beside a model axis) runs
# these only
POD_ARCHS = ("xlstm-1.3b", "qwen3-4b")
PLAIN_MESHES = ("2x2", "4x1", "1x2")
GB, S, STEPS = 4, 16, 2
RANK_TIMEOUT_S = 600


@pytest.fixture(autouse=True)
def _no_process_group_left():
    """``train`` starts a world-1 process group where none exists; end it,
    so that no later test of this process finds one."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


# ---------------------------------------------------------------------------
# placements on meta tensors
# ---------------------------------------------------------------------------

class _Mesh:
    """Both packages' view of a mesh: the reference reads ``axis_names``
    and ``devices.shape``, the port ``mesh_dim_names`` and ``mesh.shape``."""

    def __init__(self, names, shape):
        self.axis_names = self.mesh_dim_names = names
        self.devices = self.mesh = np.zeros(shape)


_JSTATES = {}


def _jstate(arch):
    if arch not in _JSTATES:
        from repro.models.steps import abstract_train_state
        _JSTATES[arch] = abstract_train_state(jconfigs.get_config(arch))
    return _JSTATES[arch]


_PLACE_MESHES = {"2x2": (("data", "model"), (2, 2)),
                 "4x1": (("data", "model"), (4, 1)),
                 "1x4": (("data", "model"), (1, 4)),
                 "pod2x2x2": (("pod", "data", "model"), (2, 2, 2))}


@pytest.mark.parametrize("mesh_id", list(_PLACE_MESHES))
@pytest.mark.parametrize("arch", jconfigs.arch_ids())
def test_placements_follow_the_reference_policy(arch, mesh_id):
    mesh = _Mesh(*_PLACE_MESHES[mesh_id])
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    cfg = configs.get_config(arch)
    model = Model(cfg, "meta")
    pol = ShardingPolicy(mesh)
    pl = placement(model, pol)
    jpol = jsharding.ShardingPolicy(mesh)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jpol.spec_tree(_jstate(arch)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    jspecs = {jsharding._path_str(p): tuple(s) for p, s in flat}
    n_sharded = 0
    for name, p in model.named_parameters():
        path, u = reference_slot(name, cfg)
        jspec = jspecs["/".join(("params",) + path)]
        want = jspec[1:] if u is not None else jspec
        assert pl.specs[name] == want, name
        assert pl.placements[name] == placements(want, mesh), name
        # the block a rank holds: 1 / (the product of the spec's sizes)
        div = 1
        for ax in want:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                div *= sizes[a] if a is not None else 1
        assert np.prod(pl.local_shape(name)) * div == p.numel(), name
        n_sharded += div > 1
    assert n_sharded > 0
    assert sorted((p, tuple(s), tuple(sp)) for p, s, sp in jpol.decisions) \
        == sorted(pol.decisions)
    assert pol.replicated_report() == jpol.replicated_report()
    state, batch = make_train_shardings(
        ShardingPolicy(mesh), train_state_shapes(model), {"tokens": (8, 16)})
    assert dict(_leaves(state)) == {
        path: placements(spec, mesh) for path, spec in jspecs.items()}
    assert batch["tokens"] == placements(
        tuple(jpol.batch_spec((8, 16))), mesh)


# ---------------------------------------------------------------------------
# gloo ranks
# ---------------------------------------------------------------------------

# With ``grad_compress``: each step's int8 codes of every port tensor
# (gathered whole on a placed run) and its leaf's largest |gradient + error
# feedback| (127 x the scale), and the whole parameters by port name, so
# that a placed compressed run is held to one process code by code.
_RECORD_CODES = r"""
import numpy as np
from repro_torch.models import steps as _steps
from repro_torch.optim import compression as _comp


def record_codes():
    # patches the train step's compress_decompress; returns the list that
    # receives one {"codes/<port name>": whole int8 codes, "reach/<port
    # name>": 127 x its scale} a step, and the undo
    log = []
    orig_cd, orig_q = _steps.compress_decompress, _comp.quantize_leaf

    def cd(grads, ef, *, leaves, placement=None):
        order = [k for ks in _comp._groups(grads, leaves).values()
                 for k in ks]
        got = []

        def q(g, scale):
            codes, sc = orig_q(g, scale)
            got.append((codes.clone(), float(127 * sc)))
            return codes, sc
        _comp.quantize_leaf = q
        try:
            out = orig_cd(grads, ef, leaves=leaves, placement=placement)
        finally:
            _comp.quantize_leaf = orig_q
        rec = {}
        for k, (c, reach) in zip(order, got):
            rec[f"codes/{k}"] = (c if placement is None else placement.full(
                k, c.float())).numpy().astype(np.int8)
            rec[f"reach/{k}"] = np.float64(reach)
        log.append(rec)
        return out

    def undo():
        _steps.compress_decompress = orig_cd
    _steps.compress_decompress = cd
    return log, undo


def port_params(model):
    pl = getattr(model, "placement", None)
    return {k: (p.detach() if pl is None else pl.full(k, p)).numpy()
            for k, p in model.named_parameters()}
"""

_RANK_PROG = _RECORD_CODES + r"""
import datetime, json, math, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import train
from repro_torch.models.convert import train_state_to_numpy
from repro_torch.models.model import placement_summary

spec, store, out_dir, rank = sys.argv[1:5]
spec = json.loads(spec)
rank = int(rank)
shape = tuple(spec["mesh"])
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=math.prod(shape),
                        timeout=datetime.timedelta(seconds=120))
mesh = init_device_mesh("cpu", shape, mesh_dim_names=(
    ("pod", "data", "model") if len(shape) == 3 else ("data", "model")))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def holdings(state):
    # names whose block is not 1 / (the product of its spec's sizes)
    pl = state.model.placement
    bad, both = [], 0
    for k, p in state.model.named_parameters():
        div = math.prod(pl.sizes[a] for a in pl.shard_dims(k))
        want = math.prod(pl.shapes[k]) // div
        for t in (p, state.opt.m[k], state.opt.v[k]):
            if t.numel() != want or t.numel() * div != math.prod(pl.shapes[k]):
                bad.append(k)
        both += len(pl.shard_dims(k)) == 2
    return bad, both


for case in spec["cases"]:
    cfg = get_smoke_config(case["arch"]).with_overrides(
        dtype=case.get("dtype", "float32"), **case.get("over", {}))
    kw = dict(global_batch=spec["gb"], seq_len=spec["s"], lr=spec["lr"],
              mesh=mesh, device="cpu",
              grad_compress=case.get("compress", False),
              ckpt_dir=case.get("ckpt"),
              checkpoint_every=case.get("every", 0))
    if case.get("fail_at"):
        try:
            train(cfg, steps=case["steps"],
                  simulate_failure_at=case["fail_at"], **kw)
            raise AssertionError("the simulated failure did not raise")
        except RuntimeError as e:
            assert "simulated" in str(e), e
    if case.get("compress"):
        code_log, undo = record_codes()
    out = train(cfg, steps=case["steps"], **kw)
    state = out["state"]
    extra = {}
    if case.get("compress"):
        undo()
        extra.update({f"{k.split('/')[0]}{t}/{k.split('/', 1)[1]}": v
                      for t, rec in enumerate(code_log)
                      for k, v in rec.items()})
        extra.update({f"port/{k}": v
                      for k, v in port_params(state.model).items()})
    bad, both = holdings(state)
    summary = placement_summary(state.model, state.opt)
    tree = train_state_to_numpy(state.model, state.opt)
    np.savez(f"{out_dir}/{case['id']}_r{rank}.npz",
             losses=np.array([m["loss"] for m in out["metrics"]]),
             gnorms=np.array([m["grad_norm"] for m in out["metrics"]]),
             meta=np.array(json.dumps({
                 "start_step": out["start_step"],
                 "steps": [m["step"] for m in out["metrics"]],
                 "bad": bad, "both": both,
                 "tp_blocks": summary["tensor_parallel_blocks"]})),
             **flat(tree), **extra)
dist.destroy_process_group()
"""


def _cases(mesh_id, tmp):
    if mesh_id == "pod2x2x2":
        return [{"id": arch, "arch": arch, "steps": STEPS}
                for arch in POD_ARCHS]
    cases = [{"id": arch, "arch": arch, "steps": STEPS}
             for arch in QK_NORM_ARCHS if MESHES[mesh_id][-1] > 1]
    for arch in ARCHS:
        cases.append({"id": f"{arch}", "arch": arch, "steps": STEPS})
        cases.append({"id": f"{arch}-init", "arch": arch, "steps": 0})
        if mesh_id != "1x2" or arch in ("xlstm-1.3b", "qwen2-1.5b"):
            cases.append({"id": f"{arch}-compress", "arch": arch,
                          "steps": STEPS, "compress": True})
    if mesh_id == "2x2":
        cases += [
            {"id": f"{arch}-bf16", "arch": arch, "steps": STEPS,
             "dtype": "bfloat16", "over": {"bf16_weight_gather": True}}
            for arch in ("xlstm-1.3b", "qwen2-1.5b")]
        cases += [
            {"id": "ckpt-write", "arch": "qwen2-1.5b", "steps": STEPS,
             "ckpt": str(tmp / "ckpt-write"), "every": 2},
            {"id": "ckpt-read", "arch": "qwen2-1.5b", "steps": 0,
             "ckpt": str(tmp / "ckpt-read")},
            {"id": "resume", "arch": "qwen2-1.5b", "steps": 4,
             "ckpt": str(tmp / "resume"), "every": 2, "fail_at": 3}]
    return cases


def _reference_generation(path):
    """A generation of the reference's train state (its init at PRNGKey(3)
    through its ``_flatten_state`` and store) at step 0; returns its flat
    dict."""
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b").with_overrides(
        dtype="float32")
    flat = j_flatten_state(j_init_train_state(jax.random.PRNGKey(3), jcfg))
    JCheckpointStore(str(path)).save(flat, step=0)
    return flat


_RUNS = {}


def _ranks(mesh_id, tmp_path_factory):
    """Run every case of a mesh in one set of gloo rank processes, once;
    returns {case id: [each rank's npz dict]} and the case list."""
    if mesh_id in _RUNS:
        return _RUNS[mesh_id]
    tmp = tmp_path_factory.mktemp(f"placed-{mesh_id}")
    cases = _cases(mesh_id, tmp)
    extra = {}
    if mesh_id == "2x2":
        extra["reference_flat"] = _reference_generation(tmp / "ckpt-read")
    shape = MESHES[mesh_id]
    spec = {"mesh": shape, "gb": GB, "s": S, "lr": LR, "cases": cases}
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    world = int(np.prod(shape))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_PROG, json.dumps(spec),
         str(tmp / "store"), str(tmp), str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-4000:] for log in logs)
    out = {c["id"]: [dict(np.load(tmp / f"{c['id']}_r{r}.npz"))
                     for r in range(world)] for c in cases}
    for runs in out.values():
        for got in runs:
            got["meta"] = json.loads(str(got["meta"]))
    _RUNS[mesh_id] = (out, {c["id"]: c for c in cases}, tmp, extra)
    return _RUNS[mesh_id]


_ONE = {}
_REC: dict = {}
exec(_RECORD_CODES, _REC)


def _one_process(arch, dtype="float32", over=(), compress=False, steps=STEPS):
    """(metrics, the gathered train state tree) of ``train`` in this
    process (world 1) for a case; with ``compress`` the tree also holds
    each step's codes (``codes<t>/<port name>``) and the parameters by port
    name (``port/<name>``), as the rank program saves them."""
    key = (arch, dtype, tuple(sorted(dict(over).items())), compress, steps)
    if key not in _ONE:
        cfg = get_smoke_config(arch).with_overrides(dtype=dtype, **dict(over))
        if compress:
            code_log, undo = _REC["record_codes"]()
        try:
            out = train(cfg, steps=steps, global_batch=GB, seq_len=S, lr=LR,
                        device="cpu", grad_compress=compress)
        finally:
            if compress:
                undo()
        tree = dict(_leaves(train_state_to_numpy(out["state"].model,
                                                 out["state"].opt)))
        if compress:
            tree.update({f"{k.split('/')[0]}{t}/{k.split('/', 1)[1]}": v
                         for t, rec in enumerate(code_log)
                         for k, v in rec.items()})
            tree.update({f"port/{k}": v for k, v in
                         _REC["port_params"](out["state"].model).items()})
        _ONE[key] = (out["metrics"], tree)
        dist.destroy_process_group()
    return _ONE[key]


def _assert_compressed(got, want):
    """A compressed run held to another code by code: every parameter
    element whose int8 code was the same in both runs at every step within
    DP_TOL; an element whose code differs (a target on a rounding boundary,
    summed in another order) within 2·lr, the most two AdamW steps of
    |m̂ / √v̂| <= 1 can part it by; at each step at most MAX_CODE_FLIPS of
    all elements flipped, not counting a leaf whose largest |target| is
    below NOISE_REACH.  Returns whether any code flipped, a step each."""
    names = [k[len("port/"):] for k in want if k.startswith("port/")]
    assert names
    total = sum(want[f"port/{k}"].size for k in names)
    counted, any_flip = [0] * STEPS, [False] * STEPS
    for k in names:
        flipped = np.zeros(want[f"port/{k}"].shape, bool)
        for t in range(STEPS):
            f = got[f"codes{t}/{k}"] != want[f"codes{t}/{k}"]
            if want[f"reach{t}/{k}"] >= NOISE_REACH:
                counted[t] += int(f.sum())
            any_flip[t] |= bool(f.any())
            flipped |= f
        diff = np.abs(got[f"port/{k}"].astype(np.float64)
                      - want[f"port/{k}"])
        assert diff[~flipped].max(initial=0.0) <= DP_TOL, (
            k, diff[~flipped].max())
        assert diff.max() <= 2 * LR, (k, diff.max())
    assert max(counted) <= MAX_CODE_FLIPS * total, (counted, total)
    return any_flip


def _assert_params(got, want, prefix, pooled=False):
    """Every parameter within DP_TOL; or (``pooled``) within 4·lr and 99 %
    of all their elements within DP_TOL."""
    keys = [k for k in want if k.startswith(prefix)]
    assert keys and all(k in got for k in keys)
    diffs = []
    for k in keys:
        diff = np.abs(got[k].astype(np.float64) - want[k])
        diffs.append(diff.ravel())
        if pooled:
            assert diff.max() <= 4 * LR, k
        else:
            assert diff.max() <= DP_TOL, (k, diff.max())
    if pooled:
        assert (np.concatenate(diffs) <= DP_TOL).mean() >= 0.99


def _train_cases():
    out = [(mesh_id, arch, False) for mesh_id in PLAIN_MESHES
           for arch in QK_NORM_ARCHS if MESHES[mesh_id][-1] > 1]
    out += [("pod2x2x2", arch, False) for arch in POD_ARCHS]
    for mesh_id in PLAIN_MESHES:
        for arch in ARCHS:
            out.append((mesh_id, arch, False))
            if mesh_id != "1x2" or arch in ("xlstm-1.3b", "qwen2-1.5b"):
                out.append((mesh_id, arch, True))
    return out


@pytest.mark.parametrize("mesh_id,arch,compress", _train_cases())
def test_placed_run_equals_one_process(mesh_id, arch, compress,
                                       tmp_path_factory):
    runs, _, _, _ = _ranks(mesh_id, tmp_path_factory)
    metrics, want = _one_process(arch, compress=compress)
    wl = [m["loss"] for m in metrics]
    wg = [m["grad_norm"] for m in metrics]
    for got in runs[arch + ("-compress" if compress else "")]:
        flipped = [False] * STEPS
        if compress:
            flipped = _assert_compressed(got, want)
        else:
            _assert_params(got, want, "params/")
        for i in range(STEPS):
            np.testing.assert_allclose(got["losses"][i], wl[i],
                                       rtol=DP_TOL, atol=0)
            # a step's norm is the dequantized gradient's: a flipped code
            # enters it
            np.testing.assert_allclose(
                got["gnorms"][i], wg[i], atol=0,
                rtol=COMPRESS_FLIP_RTOL if flipped[i] else DP_TOL)
        assert got["meta"]["bad"] == []
        # the attention families run tensor-parallel where model > 1
        tp = MESHES[mesh_id][-1] > 1 and arch != "xlstm-1.3b"
        assert (got["meta"]["tp_blocks"] > 0) == tp


@pytest.mark.parametrize("mesh_id", PLAIN_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_init_is_the_world_one_init(mesh_id, arch, tmp_path_factory):
    """Bit-equal params (and zero moments) gathered back from the blocks;
    each rank held 1 / (its spec's sizes) of params, m and v."""
    runs, _, _, _ = _ranks(mesh_id, tmp_path_factory)
    _, want = _one_process(arch, steps=0)
    for got in runs[f"{arch}-init"]:
        assert got["meta"]["bad"] == []
        for k, w in want.items():
            assert np.array_equal(got[k], w), k
    if mesh_id == "2x2":
        # some tensors are sharded over both axes: 1 / 4 a rank
        assert runs[f"{arch}-init"][0]["meta"]["both"] > 0


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "qwen2-1.5b"])
def test_bf16_weight_gather_placed_run_equals_one_process(
        arch, tmp_path_factory):
    runs, _, _, _ = _ranks("2x2", tmp_path_factory)
    over = {"bf16_weight_gather": True}
    metrics, want = _one_process(arch, dtype="bfloat16", over=over)
    for got in runs[f"{arch}-bf16"]:
        np.testing.assert_allclose(got["losses"],
                                   [m["loss"] for m in metrics],
                                   rtol=LOSS_RTOL_BF16, atol=0)
        np.testing.assert_allclose(got["gnorms"],
                                   [m["grad_norm"] for m in metrics],
                                   rtol=GNORM_RTOL_BF16, atol=0)
        _assert_params(got, want, "params/", pooled=True)
        for k in want:
            if k.startswith("params/"):
                assert got[k].dtype == np.float32, k   # fp32 masters


def test_placed_generation_restores_at_world_one_and_in_the_reference(
        tmp_path_factory):
    runs, cases, _, _ = _ranks("2x2", tmp_path_factory)
    ckpt = cases["ckpt-write"]["ckpt"]
    placed = runs["ckpt-write"][0]
    # the port at world 1: the newest generation, at its step
    cfg = get_smoke_config("qwen2-1.5b").with_overrides(dtype="float32")
    out = train(cfg, steps=STEPS, global_batch=GB, seq_len=S, lr=LR,
                device="cpu", ckpt_dir=ckpt)
    assert out["start_step"] == STEPS and out["metrics"] == []
    got = dict(_leaves(to_numpy_params(out["state"].model)))
    for k, w in got.items():
        assert np.array_equal(placed["params/" + k], w), k
    # the reference's layout: every key, every leaf
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b").with_overrides(
        dtype="float32")
    template = j_init_train_state(jax.random.PRNGKey(0), jcfg)
    flat = JCheckpointStore(ckpt).load()
    assert sorted(j_flatten_state(template)) == sorted(flat)
    jstate = j_unflatten_state(template, flat)
    for key, arr in j_flatten_state(jstate).items():
        assert np.array_equal(arr, placed[key]), key


def test_reference_generation_restores_into_a_placed_run(tmp_path_factory):
    runs, _, _, extra = _ranks("2x2", tmp_path_factory)
    want = extra["reference_flat"]
    for got in runs["ckpt-read"]:
        assert got["meta"]["start_step"] == 0
        for key, arr in want.items():
            assert np.array_equal(got[key], np.asarray(arr)), key


def test_placed_run_resumes_at_the_saved_step(tmp_path_factory, tmp_path):
    runs, _, _, _ = _ranks("2x2", tmp_path_factory)
    cfg = get_smoke_config("qwen2-1.5b").with_overrides(dtype="float32")
    kw = dict(steps=4, global_batch=GB, seq_len=S, lr=LR, device="cpu",
              ckpt_dir=str(tmp_path / "one"), checkpoint_every=2)
    with pytest.raises(RuntimeError, match="simulated"):
        train(cfg, simulate_failure_at=3, **kw)
    dist.destroy_process_group()
    one = train(cfg, **kw)
    want = dict(_leaves(to_numpy_params(one["state"].model)))
    for got in runs["resume"]:
        assert got["meta"]["start_step"] == 2
        assert got["meta"]["steps"] == [3, 4]
        np.testing.assert_allclose(
            got["losses"], [m["loss"] for m in one["metrics"]],
            rtol=DP_TOL, atol=0)
        for k, w in want.items():
            assert np.abs(got["params/" + k] - w).max() <= DP_TOL, k


def test_a_mesh_of_another_device_type_is_refused(monkeypatch):
    """A CPU mesh for a state on the card raises (the device resolved as a
    card's here, where there is none)."""
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(1, 1, device="cpu")
    monkeypatch.setattr(train_mod, "resolve_device",
                        lambda d: torch.device("cuda"))
    with pytest.raises(ValueError, match="cpu mesh for a train state on "
                                         "cuda"):
        train(get_smoke_config("qwen2-1.5b"), steps=1, global_batch=2,
              seq_len=8, mesh=mesh, device="cuda")


def test_a_placement_that_cannot_be_made_raises():
    """A spec whose axis does not divide its dim (forced) is refused."""
    mesh = _Mesh(("data", "model"), (2, 2))
    cfg = configs.get_smoke_config("qwen2-1.5b")
    pol = ShardingPolicy(mesh)
    orig = pol.param_spec
    pol.param_spec = lambda path, shape: (
        ("data",) + (None,) * (len(shape) - 1) if path.endswith("embed")
        and len(shape) == 2 else orig(path, shape))
    model = Model(cfg.with_overrides(vocab_size=255), "meta")
    with pytest.raises(ValueError, match="does not split"):
        placement(model, pol)
