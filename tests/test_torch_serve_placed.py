"""Serving on a placed model (``repro_torch.models.model.decode_step`` on the
policy's placement) with a placed decode state, on 4 gloo rank processes
(a file store, a timeout on every subprocess) against one process and the
JAX reference.

* Every family's smoke config in fp32, the weights from the JAX init
  (``models.convert``), 4 sequences teacher-forced for 20 steps over a
  16-slot cache (windowed blocks wrap their ring): placed at (4, 1) with
  the base policy (each rank one sequence) and at (2, 2) with
  ``shard_cache_seq`` (each ``data`` rank two sequences, each ``model``
  rank 8 of every KV cache's slots, merged by ``SeqShard``), every step's
  logits within 1e-5 × the largest |logit| of the whole model's decode in
  the same process and the same argmax; every decode-state leaf the policy
  replicates over ``model`` equal on every ``model`` rank after every
  step.  Encoder-decoder models place a whole state whose cross K/V the
  whole model computed (``place_decode_state``).
* The whole model's decode (world 1) equals the JAX ``decode_step`` within
  the families' fp32 tolerance (``FP32_ATOL``).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import model as jmodel
from repro_torch import configs

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
ARCHS = configs.arch_ids()
B, CACHE, STEPS, ENC_FRAMES = 4, 16, 20, 12
REL_TOL = 1e-5
FP32_ATOL = 1e-4
RANK_TIMEOUT_S = 300

_RANK_PROG = r"""
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import arch_ids, get_smoke_config
from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch.models import encode, init_decode_state
from repro_torch.models.convert import from_numpy_params, placement
from repro_torch.models.model import (decode_leaves, decode_state_specs,
                                      decode_step, place_decode_state)

tmp, rank = sys.argv[1], int(sys.argv[2])
B, CACHE, STEPS = (int(x) for x in sys.argv[3:6])
dist.init_process_group("gloo", init_method="file://" + tmp + "/store",
                        rank=rank, world_size=4,
                        timeout=datetime.timedelta(seconds=120))
torch.set_grad_enabled(False)


def tree_of(npz):
    tree = {}
    for k in npz.files:
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = npz[k]
    return tree


def placed_model(tree, cfg, policy):
    model = from_numpy_params(tree, cfg, device="cpu")
    pl = placement(model, policy)
    for name, p in list(model.named_parameters()):
        p.data = pl.shard(name, p.data).clone()
    pl.bind(model)
    return model


out = {}
for arch in arch_ids():
    cfg = get_smoke_config(arch).with_overrides(dtype="float32")
    data = np.load(f"{tmp}/{arch}.npz")
    tree = tree_of(np.load(f"{tmp}/{arch}_params.npz"))
    toks = torch.as_tensor(data["tokens"])
    whole = from_numpy_params(tree, cfg, device="cpu")
    enc = None
    if cfg.is_enc_dec:
        enc = encode(whole, torch.as_tensor(data["frames"]), cfg)
    want, st = [], init_decode_state(cfg, B, CACHE, enc_out=enc,
                                     params=whole, device="cpu")
    for t in range(STEPS):
        lg, st = decode_step(whole, st, toks[:, t:t + 1], cfg)
        want.append(lg)
    if rank == 0:
        np.save(f"{tmp}/{arch}_world1.npy",
                torch.stack(want).numpy())
    for tag, shape, flags in (("4x1", (4, 1), {}),
                              ("2x2", (2, 2), {"shard_cache_seq": True})):
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        policy = ShardingPolicy(mesh, **flags)
        model = placed_model(tree, cfg, policy)
        pl = model.placement
        whole_state = init_decode_state(cfg, B, CACHE, enc_out=enc,
                                        params=whole, device="cpu")
        state = (place_decode_state(whole_state, cfg, pl) if cfg.is_enc_dec
                 else init_decode_state(cfg, B, CACHE, device="cpu",
                                        placement=pl))
        specs = decode_state_specs(whole_state, cfg, policy)
        nb = state.pos.shape[0]
        lo = mesh.get_coordinate()[0] * nb if nb < B else 0
        err, argmax, replicated = 0.0, True, True
        for t in range(STEPS):
            lg, state = decode_step(model, state, toks[lo:lo + nb, t:t + 1],
                                    cfg)
            ref = want[t][lo:lo + nb]
            err = max(err, float((lg - ref).abs().max()
                                 / ref.abs().max()))
            argmax &= bool(torch.equal(lg.argmax(-1), ref.argmax(-1)))
            if shape[1] > 1:
                for key, _, _, leaf in decode_leaves(state, cfg):
                    if "model" in specs[key]:
                        continue
                    got = [torch.empty_like(leaf) for _ in range(shape[1])]
                    dist.all_gather(got, leaf.contiguous(),
                                    group=mesh.get_group("model"))
                    replicated &= all(torch.equal(g, got[0]) for g in got)
        out[f"{arch}/{tag}"] = {
            "err": err, "argmax": argmax, "replicated": replicated,
            "seq_shards": max(state.seq_shards), "rows": nb,
            "pos": state.pos.tolist()}
with open(f"{tmp}/rank{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""

_RUN = {}


def _inputs(arch, tmp):
    """Write the JAX init's weights and the tokens (and frames) of the
    decode; returns what ``_jax_logits`` needs."""
    jcfg = jconfigs.get_smoke_config(arch).with_overrides(dtype="float32")
    jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    np.savez(tmp / f"{arch}_params.npz", **{
        "/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
        for p, v in flat})
    rng = np.random.RandomState(7)
    toks = rng.randint(0, jcfg.vocab_size, (B, STEPS)).astype(np.int32)
    data = {"tokens": toks}
    jst = jmodels.init_decode_state(jcfg, B, CACHE)
    if jcfg.is_enc_dec:
        data["frames"] = rng.randn(B, ENC_FRAMES, jcfg.d_model).astype(
            np.float32)
        jenc = jmodel.encode(jp, jnp.asarray(data["frames"]), jcfg)
        jst = jst._replace(cross_kv=jmodel.precompute_cross_kv(jp, jenc,
                                                               jcfg))
    np.savez(tmp / f"{arch}.npz", **data)
    return jp, jst, toks, jcfg


def _jax_logits(jp, jst, toks, jcfg):
    """The JAX decode's logits of every step."""
    step = jax.jit(jmodels.decode_step, static_argnums=3)
    logits = []
    for t in range(STEPS):
        jl, jst = step(jp, jst, jnp.asarray(toks[:, t:t + 1]), jcfg)
        logits.append(np.asarray(jl))
    return np.stack(logits)


def _runs(tmp_path_factory):
    if not _RUN:
        tmp = tmp_path_factory.mktemp("serve-placed")
        inputs = {arch: _inputs(arch, tmp) for arch in ARCHS}
        env = dict(os.environ)
        env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
        env["OMP_NUM_THREADS"] = "1"
        procs = [subprocess.Popen(
            [sys.executable, "-W", "ignore", "-c", _RANK_PROG, str(tmp),
             str(r), str(B), str(CACHE), str(STEPS)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(4)]
        logs = []
        try:
            # the reference's logits while the ranks run
            jax_logits = {a: _jax_logits(*v) for a, v in inputs.items()}
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                p.kill()
        assert all(p.returncode == 0 for p in procs), "\n".join(
            log[-3000:] for log in logs)
        _RUN["ranks"] = [json.load(open(tmp / f"rank{r}.json"))
                         for r in range(4)]
        _RUN["world1"] = {a: np.load(tmp / f"{a}_world1.npy")
                          for a in ARCHS}
        _RUN["jax"] = jax_logits
    return _RUN


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_decode_equals_world_1(arch, tmp_path_factory):
    ranks = _runs(tmp_path_factory)["ranks"]
    for tag, rows, shards in (("4x1", 1, 1), ("2x2", 2, 2)):
        for r, got in enumerate(ranks):
            res = got[f"{arch}/{tag}"]
            assert res["err"] <= REL_TOL, (tag, r, res)
            assert res["argmax"] and res["replicated"], (tag, r, res)
            assert res["rows"] == rows and res["pos"] == [STEPS] * rows
            # every KV cache of the (2, 2) state split over model
            has_cache = any(bt not in ("rglru", "mlstm", "slstm")
                            for bt in configs.get_smoke_config(
                                arch).block_pattern)
            assert res["seq_shards"] == (shards if has_cache else 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_world_1_decode_equals_jax(arch, tmp_path_factory):
    run = _runs(tmp_path_factory)
    np.testing.assert_allclose(run["world1"][arch], run["jax"][arch],
                               rtol=0, atol=FP32_ATOL)
