"""Sequence parallelism and the dry run's other train policies on 4 gloo rank
processes (a file store, a timeout on every subprocess), through
``launch.train.train`` on a (2, 2) mesh, fp32, 2 steps of 8 x 32 tokens.

* qwen2 and recurrentgemma (their smoke configs) with ``sequence_parallel``
  against the same mesh without it; xlstm under the ``dp_only`` and
  ``head_proj_model_only`` policies (``train(policy=...)``) and
  recurrentgemma under ``head_proj_model_only``, against the replicated
  data-parallel step with the same rows a rank (``scripts/train_cards.py``'s
  baseline: every rank the whole model, the gradients summed over each
  batch axis in turn).
* The 4-card agreement check's rule (``scripts/train_cards.py``): losses
  and grad norms within ``DP_TOL`` = 1e-5 relative.  Where the run sums
  partial products over ``model`` (a tensor-parallel block, or sequence
  parallelism) each parameter's step-1 gradient (gathered whole) at most
  ``WITNESS_RATIO`` = 2 times as far from the fp64 witness
  (``launch.witness``, relative L2) as the baseline's; where it does not,
  every parameter after the 2 steps within ``DP_TOL`` of the baseline's.
* Under sequence parallelism the residual stream holds each ``model``
  rank's slice of the sequence: the collectives include the sequence
  gathers and reduce-scatters (more reduce-scatters than without).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
DP_TOL = 1e-5
WITNESS_RATIO = 2.0
RANK_TIMEOUT_S = 300
# (case, arch, the run's config / policy); a run with a policy is held to
# the replicated step, one with sequence parallelism to the placed step
# without it
CASES = {
    "qwen2_sp": ("qwen2-1.5b", {"sequence_parallel": True}),
    "recurrentgemma_sp": ("recurrentgemma-9b", {"sequence_parallel": True}),
    "xlstm_dp_only": ("xlstm-1.3b", {"policy": {"dp_only": True}}),
    "xlstm_head_proj": ("xlstm-1.3b",
                        {"policy": {"head_proj_model_only": True}}),
    "recurrentgemma_head_proj": ("recurrentgemma-9b", {
        "policy": {"head_proj_model_only": True}}),
}

_RANK_PROG = r"""
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import lm_batches
from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch.launch import train as train_mod
from repro_torch.launch.witness import witness_grads
from repro_torch.models import init_train_state, make_train_step
from repro_torch.models.model import placement_summary
from repro_torch.optim import adamw

tmp, rank = sys.argv[1], int(sys.argv[2])
cases = json.loads(sys.argv[3])
dist.init_process_group("gloo", init_method="file://" + tmp + "/store",
                        rank=rank, world_size=4,
                        timeout=datetime.timedelta(seconds=120))
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
B, S, STEPS = 8, 32, 2


class first_grads:
    def __enter__(self):
        self.grads, self.orig = [], adamw.apply_updates

        def spy(params, g, state, opt_cfg, **kw):
            if not self.grads:
                self.grads.append({k: v.detach().clone()
                                   for k, v in g.items()})
            return self.orig(params, g, state, opt_cfg, **kw)
        adamw.apply_updates = spy
        return self

    def __exit__(self, *exc):
        adamw.apply_updates = self.orig


def run(cfg, policy):
    with first_grads() as rec:
        out = train_mod.train(cfg, steps=STEPS, global_batch=B, seq_len=S,
                              mesh=mesh, device="cpu", log_every=1,
                              policy=ShardingPolicy(mesh, **policy))
    state = out["state"]
    pl = state.model.placement
    grads = {k: pl.full(k, v).double().numpy()
             for k, v in rec.grads[0].items()}
    params = {k: pl.full(k, p).double().numpy()
              for k, p in state.model.named_parameters()}
    metrics = [(m["loss"], m["grad_norm"]) for m in out["metrics"]]
    tp = placement_summary(state.model, state.opt)["tensor_parallel_blocks"]
    return metrics, grads, params, {"counts": dict(pl.counts), "tp": tp}


def replicated(cfg, policy):
    pol = ShardingPolicy(mesh, **policy)
    rows = train_mod._batch_rows(mesh, pol, B)
    gen = torch.Generator()
    gen.manual_seed(0)
    state = init_train_state(cfg, generator=gen, device="cpu")
    groups = (train_mod._batch_groups(mesh, pol)
              if rows != slice(0, B) else None)
    step = make_train_step(cfg, train_mod.opt_config(STEPS, 3e-4),
                           groups=groups)
    data = lm_batches(cfg.vocab_size, B, S, seed=0)
    metrics = []
    with first_grads() as rec:
        for _ in range(STEPS):
            state, m = step(state, train_mod.rank_batch(next(data), rows,
                                                        cfg, S, "cpu"))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    grads = {k: v.double().numpy() for k, v in rec.grads[0].items()}
    params = {k: p.detach().double().numpy()
              for k, p in state.model.named_parameters()}
    return metrics, grads, params, {}


out = {}
for name, (arch, run_kw) in cases.items():
    cfg = get_smoke_config(arch).with_overrides(dtype="float32")
    run_kw = dict(run_kw)
    policy = run_kw.pop("policy", {})
    res = {}
    for tag, go in (("run", lambda: run(cfg.with_overrides(**run_kw),
                                        policy)),
                    ("base", lambda: (run(cfg, policy) if run_kw
                                      else replicated(cfg, policy)))):
        metrics, grads, params, info = go()
        res[tag] = {"metrics": metrics, **info}
        if rank == 0:
            np.savez(f"{tmp}/{name}_{tag}.npz", **grads)
            np.savez(f"{tmp}/{name}_{tag}_params.npz", **params)
    if rank == 0:
        np.savez(f"{tmp}/{name}_witness.npz",
                 **{k: v.numpy() for k, v in witness_grads(cfg, B, S).items()})
    out[name] = res
with open(f"{tmp}/rank{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""

_RUN = {}


def _runs(tmp_path_factory):
    if not _RUN:
        tmp = tmp_path_factory.mktemp("seq-parallel")
        env = dict(os.environ)
        env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
        env["OMP_NUM_THREADS"] = "1"
        procs = [subprocess.Popen(
            [sys.executable, "-W", "ignore", "-c", _RANK_PROG, str(tmp),
             str(r), json.dumps(CASES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(4)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                p.kill()
        assert all(p.returncode == 0 for p in procs), "\n".join(
            log[-3000:] for log in logs)
        _RUN["ranks"] = [json.load(open(tmp / f"rank{r}.json"))
                         for r in range(4)]
        _RUN["tmp"] = tmp
    return _RUN


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-300))


@pytest.mark.parametrize("case", list(CASES))
def test_agrees_under_the_witness_rule(case, tmp_path_factory):
    run = _runs(tmp_path_factory)
    res = run["ranks"][0][case]
    for (loss, gnorm), (bloss, bgnorm) in zip(res["run"]["metrics"],
                                              res["base"]["metrics"]):
        assert abs(loss / bloss - 1) <= DP_TOL
        assert abs(gnorm / bgnorm - 1) <= DP_TOL
    for r in run["ranks"][1:]:          # every rank reports the same losses
        assert r[case]["run"]["metrics"] == res["run"]["metrics"]
    tmp = run["tmp"]
    got = np.load(tmp / f"{case}_run.npz")
    base = np.load(tmp / f"{case}_base.npz")
    wit = np.load(tmp / f"{case}_witness.npz")
    assert set(got.files) == set(wit.files)
    for k in wit.files:
        assert _rel_l2(got[k], wit[k]) <= WITNESS_RATIO * _rel_l2(
            base[k], wit[k]), k
    if res["run"]["tp"] == 0 and "sequence_parallel" not in CASES[case][1]:
        # no partial products summed over ``model``: the parameters too
        got_p = np.load(tmp / f"{case}_run_params.npz")
        base_p = np.load(tmp / f"{case}_base_params.npz")
        assert set(got_p.files) == set(base_p.files)
        for k in base_p.files:
            assert np.abs(got_p[k] - base_p[k]).max() <= DP_TOL, k


def test_the_rule_follows_the_run(tmp_path_factory):
    """The cases without a tensor-parallel block are those the parameter
    comparison holds: xlstm's (no block of it runs tensor-parallel)."""
    res = _runs(tmp_path_factory)["ranks"][0]
    assert res["xlstm_dp_only"]["run"]["tp"] == 0
    assert res["xlstm_head_proj"]["run"]["tp"] == 0
    assert res["qwen2_sp"]["run"]["tp"] > 0


@pytest.mark.parametrize("case", ["qwen2_sp", "recurrentgemma_sp"])
def test_the_sequence_is_split_over_model(case, tmp_path_factory):
    res = _runs(tmp_path_factory)["ranks"][0][case]
    run, base = res["run"]["counts"], res["base"]["counts"]
    assert run["reduce_scatter"] > base["reduce_scatter"]
    assert run["all_gather"] > base["all_gather"]
