"""The port's training driver (``repro_torch.launch.train``) on the CPU: the
contract of the reference's driver tests (tests/test_train_driver.py: the
loss falls, a killed run resumes from its last generation, the
encoder-decoder driver is finite), gradient compression, checkpoints
carried between the two packages, data parallelism over gloo ranks, and
the card default of the entry points.

The reference's own ``train()`` fails under the installed JAX (its sharded
init), so a generation written by the reference is made by its
``_flatten_state`` of ``init_train_state`` through its ``CheckpointStore``,
and the step it is held to is the reference's ``make_train_step`` on that
state (loss and grad norm within 1e-4 relative; parameters within 2·lr on
every element and 1e-5 on 99 % of them, as tests/test_torch_train.py).
Two gloo ranks (subprocesses, a file store) train 2 data-parallel steps
whose losses and parameters equal one process's within 1e-5 (fp32 sums
over two halves of the batch, then one all_reduce).
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
from repro.data.synthetic import lm_batches as j_lm_batches
from repro.launch.train import _flatten_state as j_flatten_state
from repro.launch.train import _unflatten_state as j_unflatten_state
from repro.models.steps import init_train_state as j_init_train_state
from repro.models.steps import make_train_step as j_make_train_step
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import _flatten_state, train
from repro_torch.models import init_train_state, make_train_step
from repro_torch.models.convert import to_numpy_params
from repro_torch.optim import AdamWConfig

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
STEP_RTOL = 1e-4
DP_TOL = 1e-5


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
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_train_smoke_loss_decreases():
    cfg = get_smoke_config("qwen2-1.5b")
    out = train(cfg, steps=8, global_batch=4, seq_len=32, lr=5e-3,
                log_every=1, device="cpu")
    losses = [m["loss"] for m in out["metrics"]]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_checkpoint_restart_resumes_step(tmp_path):
    """Kill at step 6, restart, resume from the step-4 generation and
    complete: the fault-tolerance contract."""
    cfg = get_smoke_config("qwen2-1.5b")
    ckpt = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="simulated node failure"):
        train(cfg, steps=10, global_batch=4, seq_len=32, ckpt_dir=ckpt,
              checkpoint_every=2, simulate_failure_at=6, device="cpu")
    assert CheckpointStore(ckpt).manifest().step == 4
    out = train(cfg, steps=10, global_batch=4, seq_len=32, ckpt_dir=ckpt,
                checkpoint_every=2, device="cpu")
    steps_logged = [m["step"] for m in out["metrics"]]
    assert out["start_step"] == 4
    assert steps_logged == list(range(5, 11))
    assert CheckpointStore(ckpt).manifest().step == 10


def test_enc_dec_driver():
    cfg = get_smoke_config("seamless-m4t-medium")
    out = train(cfg, steps=3, global_batch=2, seq_len=16, device="cpu")
    assert np.isfinite([m["loss"] for m in out["metrics"]]).all()


def test_grad_compress_trains():
    cfg = get_smoke_config("qwen2-1.5b")
    out = train(cfg, steps=8, global_batch=4, seq_len=32, lr=5e-3,
                grad_compress=True, device="cpu")
    losses = [m["loss"] for m in out["metrics"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_main_trains_and_recovers(tmp_path, capsys):
    train_mod.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                    "--steps", "4", "--global-batch", "2", "--seq-len", "16",
                    "--ckpt-dir", str(tmp_path / "ck"),
                    "--checkpoint-every", "2", "--simulate-failure-at", "3"])
    out = capsys.readouterr().out
    assert "simulated failure at step 3" in out
    assert "restored generation 1 at step 2" in out
    assert "recovered; final loss" in out


def _compare_step(jm, jparams, metrics, params, lr):
    """The port's first step against the reference's (trap: AdamW's first
    step is ~sign(g)·lr)."""
    for key in ("loss", "grad_norm"):
        want = float(jm[key])
        assert abs(metrics[key] - want) <= STEP_RTOL * abs(want), (
            key, metrics[key], want)
    got = dict(_leaves(params))
    diff = np.concatenate([np.abs(got[p] - w).ravel() for p, w in _leaves(
        jax.tree_util.tree_map(np.asarray, jparams))])
    assert diff.max() <= 2 * lr * 1.001, diff.max()
    assert (diff <= 1e-5).mean() >= 0.99


def _ref_first_step(jcfg, jstate, steps, gb, s, lr):
    """The reference's make_train_step on its state with the driver's
    AdamW derivation and first batch."""
    ocfg = JAdamWConfig(lr=lr, total_steps=max(steps, 2),
                        warmup_steps=min(100, steps // 10 + 1))
    nb = next(j_lm_batches(jcfg.vocab_size, gb, s, seed=0))
    batch = {"tokens": nb.tokens, "targets": nb.targets,
             "segment_ids": nb.segment_ids}
    return jax.jit(j_make_train_step(jcfg, ocfg))(jstate, batch)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "xlstm-1.3b"])
def test_reference_generation_restores_in_the_port(tmp_path, arch):
    """A generation written by the reference restores in the port's
    ``train()``, and its first step is the reference's on that state."""
    jcfg = jconfigs.get_smoke_config(arch).with_overrides(dtype="float32")
    cfg = get_smoke_config(arch).with_overrides(dtype="float32")
    jstate = j_init_train_state(jax.random.PRNGKey(3), jcfg)
    ckpt = str(tmp_path / "ck")
    JCheckpointStore(ckpt).save(j_flatten_state(jstate), step=0)
    out = train(cfg, steps=1, global_batch=4, seq_len=32, ckpt_dir=ckpt,
                device="cpu")
    assert out["start_step"] == 0
    jnew, jm = _ref_first_step(jcfg, jstate, 1, 4, 32, 3e-4)
    _compare_step(jm, jnew.params, out["metrics"][0],
                  to_numpy_params(out["state"].model), 3e-4)
    assert int(out["state"].opt.step) == int(jnew.opt.step) == 1


def test_port_generation_restores_in_the_reference(tmp_path):
    """The reverse: a generation written by the port's ``_flatten_state``
    and store restores through the reference's ``_unflatten_state``, bit
    for bit, and the reference's step from it is the port's."""
    arch = "qwen2-1.5b"
    jcfg = jconfigs.get_smoke_config(arch).with_overrides(dtype="float32")
    cfg = get_smoke_config(arch).with_overrides(dtype="float32")
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(5),
                             device="cpu")
    flat = _flatten_state(state)
    ckpt = str(tmp_path / "ck")
    CheckpointStore(ckpt).save(flat, step=0)
    template = j_init_train_state(jax.random.PRNGKey(0), jcfg)
    jstate = j_unflatten_state(template, JCheckpointStore(ckpt).load())
    assert sorted(j_flatten_state(template)) == sorted(flat)
    for key, arr in j_flatten_state(jstate).items():
        assert np.array_equal(arr, flat[key]), key
    lr = 3e-4
    jnew, jm = _ref_first_step(jcfg, jstate, 1, 4, 32, lr)
    step = make_train_step(cfg, AdamWConfig(lr=lr, total_steps=2,
                                            warmup_steps=1))
    nb = next(j_lm_batches(cfg.vocab_size, 4, 32, seed=0))
    state, m = step(state, {"tokens": torch.as_tensor(nb.tokens),
                            "targets": torch.as_tensor(nb.targets),
                            "segment_ids": torch.as_tensor(nb.segment_ids)})
    _compare_step(jm, jnew.params, {k: v.item() for k, v in m.items()},
                  to_numpy_params(state.model), lr)


_RANK_PROG = r"""
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import train
from repro_torch.models.convert import to_numpy_params

spec, store, out_path, rank = sys.argv[1:5]
spec = json.loads(spec)
dist.init_process_group("gloo", init_method="file://" + store,
                        rank=int(rank), world_size=spec["world"],
                        timeout=datetime.timedelta(seconds=120))
mesh = make_local_mesh(spec["world"], 1, device="cpu")
cfg = get_smoke_config(spec["arch"]).with_overrides(dtype="float32")
out = train(cfg, steps=spec["steps"],
            global_batch=spec["gb"], seq_len=spec["s"], lr=spec["lr"],
            mesh=mesh, device="cpu")
flat = {}
def walk(t, p):
    for k, v in t.items():
        if isinstance(v, dict):
            walk(v, p + (k,))
        else:
            flat["/".join(p + (k,))] = v
walk(to_numpy_params(out["state"].model), ())
np.savez(out_path, losses=np.array([m["loss"] for m in out["metrics"]]),
         gnorms=np.array([m["grad_norm"] for m in out["metrics"]]), **flat)
dist.destroy_process_group()
"""


def test_two_gloo_ranks_equal_one_process(tmp_path):
    spec = {"arch": "qwen2-1.5b", "world": 2, "steps": 2, "gb": 4, "s": 16,
            "lr": 5e-3}
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_PROG, json.dumps(spec),
         str(tmp_path / "store"), str(tmp_path / f"rank{r}.npz"), str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(spec["world"])]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    one = train(get_smoke_config(spec["arch"]).with_overrides(
        dtype="float32"), steps=spec["steps"],
                global_batch=spec["gb"], seq_len=spec["s"], lr=spec["lr"],
                device="cpu")
    want = dict(_leaves(to_numpy_params(one["state"].model)))
    for r in range(spec["world"]):
        got = dict(np.load(tmp_path / f"rank{r}.npz"))
        np.testing.assert_allclose(
            got.pop("losses"), [m["loss"] for m in one["metrics"]],
            rtol=DP_TOL, atol=0)
        np.testing.assert_allclose(
            got.pop("gnorms"), [m["grad_norm"] for m in one["metrics"]],
            rtol=DP_TOL, atol=0)
        assert set(got) == set(want)
        for path, w in want.items():
            assert np.abs(got[path] - w).max() <= DP_TOL, path


def test_training_entry_points_default_to_the_card(monkeypatch):
    """Without a card the entry points raise unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(cfg, steps=1, global_batch=2, seq_len=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mod.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "1"])
