"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

* The abstract builders allocate nothing: the train state, the model and
  the decode state of every arch live on the meta device.
* At the production meshes, (16, 16) and (2, 16, 16), each rank's block of
  every parameter (``Placement.local_shape``) and of every decode-state
  leaf (``models.model.decode_state_specs``) is the global shape divided as
  the reference's spec divides it (``repro.distributed.sharding``'s
  ``spec_tree`` / ``serve_state_spec``; ``serve_sharding_tree``'s
  placements those of the reference's specs), in the "base" and "opt" policies
  (a stand-in mesh object with both packages' attributes: the policies
  read only axis names and sizes).
* ``--list`` prints the reference's rows, skips and reasons included.
* In a child process that is rank 0 of a fake world of 8 (a (4, 2) mesh),
  every family's smoke config runs a train, a prefill and a decode cell in
  both variants, and the six quantixar-db cells run, each to ``ok``; the
  records carry the kernels' meta operations where the path has a kernel.
* A meta tensor reaching a kernel entry (B5's two, B6, B7, B8 and, under
  grad, B8ᵀ) returns the kernel's shapes and dtypes, launches nothing and
  counts the kernel's operations; B1's entry raises on meta.
"""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import sharding as jsharding
from repro.launch import specs as JSP
from repro.models import steps as jsteps
from repro_torch import configs
from repro_torch.distributed.sharding import ShardingPolicy, placements
from repro_torch.kernels import beam_gather, l2, ops, slstm
from repro_torch.launch import specs as SP
from repro_torch.models.convert import placement, reference_slot
from repro_torch.models.model import (_nest, abstract_decode_state,
                                      abstract_params, decode_leaves,
                                      decode_state_shapes,
                                      decode_state_specs)
from repro_torch.models.steps import abstract_train_state

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
ARCHS = configs.arch_ids()
CHILD_TIMEOUT_S = 300


class _Mesh:
    """Both packages' view of a mesh: the reference reads ``axis_names``
    and ``devices.shape``, the port ``mesh_dim_names`` and ``mesh.shape``."""

    def __init__(self, names, shape):
        self.axis_names = self.mesh_dim_names = names
        self.devices = self.mesh = np.zeros(shape)


MESHES = {"pod16x16": (("data", "model"), (16, 16)),
          "pod2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _divide(shape, spec, sizes):
    out = list(shape)
    for dim, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                assert out[dim] % sizes[a] == 0
                out[dim] //= sizes[a]
    return tuple(out)


def _flags(variant, arch, cell, sizes):
    """The reference dry run's policy flags for a cell."""
    if variant == "base":
        return {}
    cfg = jconfigs.get_config(arch)
    return {"shard_cache_seq": True, "head_proj_model_only": True,
            "dp_only": (cfg.family == "ssm"
                        and cell.global_batch % math.prod(sizes.values())
                        == 0)}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_builders_allocate_nothing(arch):
    cfg = configs.get_config(arch)
    state = abstract_train_state(cfg)
    tensors = list(state.model.parameters()) + list(state.opt.m.values()) \
        + list(state.opt.v.values())
    tensors += list(abstract_params(cfg).parameters())
    dec = abstract_decode_state(cfg, 128, 32_768,
                                with_cross_len=32_768 * cfg.is_enc_dec)
    tensors += [t for *_, t in decode_leaves(dec, cfg)]
    assert tensors and all(t.device.type == "meta" for t in tensors)


@pytest.mark.parametrize("variant", ["base", "opt"])
@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_blocks_follow_the_reference(arch, mesh_id, variant):
    mesh = _Mesh(*MESHES[mesh_id])
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    # parameters: the train_4k cell's policy
    flags = _flags(variant, arch, JSP.SHAPES["train_4k"], sizes)
    pol, jpol = ShardingPolicy(mesh, **flags), \
        jsharding.ShardingPolicy(mesh, **flags)
    model = abstract_params(cfg)
    pl = placement(model, pol)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jpol.spec_tree(jsteps.abstract_train_state(jcfg)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    jspecs = {jsharding._path_str(p): tuple(s) for p, s in flat}
    for name, p in model.named_parameters():
        path, u = reference_slot(name, cfg)
        jspec = jspecs["/".join(("params",) + path)]
        want = _divide(p.shape, jspec[1:] if u is not None else jspec,
                       sizes)
        assert pl.local_shape(name) == want, name
    # the decode state: the decode_32k cell's policy and state
    flags = _flags(variant, arch, JSP.SHAPES["decode_32k"], sizes)
    pol, jpol = ShardingPolicy(mesh, **flags), \
        jsharding.ShardingPolicy(mesh, **flags)
    _, state = SP.lm_decode_specs(cfg, SP.SHAPES["decode_32k"])
    _, jstate = JSP.lm_decode_specs(jcfg, JSP.SHAPES["decode_32k"])
    jflat, _ = jax.tree_util.tree_flatten_with_path(jstate)
    jserve = {jsharding._path_str(p): tuple(jpol.serve_state_spec(
        jsharding._path_str(p), leaf.shape)) for p, leaf in jflat}
    specs = decode_state_specs(state, cfg, pol)
    tree = pol.serve_sharding_tree(_nest({
        k: v[0] for k, v in decode_state_shapes(state, cfg).items()}))
    for path, spec in jserve.items():
        node = tree
        for k in path.split("/"):
            node = node[k]
        assert node == placements(spec, mesh), path
    seq_split = 0
    for key, path, u, t in decode_leaves(state, cfg):
        jspec = jserve[path]
        want = _divide(t.shape, jspec[1:] if u is not None else jspec,
                       sizes)
        assert _divide(t.shape, specs[key], sizes) == want, path
        seq_split += "model" in specs[key]
    assert (seq_split > 0) == (variant == "opt" and any(
        "model" in s for s in jserve.values()))


def _run(args, timeout=CHILD_TIMEOUT_S):
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-W", "ignore"] + args,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


def test_list_prints_the_references_rows():
    got = _run(["-m", "repro_torch.launch.dryrun", "--list", "--db"])
    assert got.returncode == 0, got.stderr[-2000:]
    want = []
    for arch in jconfigs.arch_ids():
        for shape in JSP.SHAPES:
            ok, why = JSP.cell_supported(jconfigs.get_config(arch), shape)
            want.append(f"{arch:24s} {shape:12s} {'run' if ok else why}")
    for mode in ("flat", "pq", "bq", "flat-rows", "pq-rows", "bq-rows"):
        want.append(f"{'quantixar-db':24s} {mode:12s} run")
    assert got.stdout.splitlines() == want


_CELLS_PROG = r"""
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import arch_ids, get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import start_fake_world

start_fake_world(8)
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
out = {}
for arch in arch_ids():
    cfg = get_smoke_config(arch)
    for kind, b, s in (("train", 8, 32), ("prefill", 4, 64),
                       ("decode", 8, 64)):
        cell = SP.ShapeCell(kind, s, b, kind)
        for variant in ("base", "opt"):
            rec = D.run_cell(
                f"{arch}__{kind}__{variant}",
                lambda m: D.build_lm_cell(arch, cell, m, variant, cfg=cfg),
                D.model_flops(cfg, cell), mesh, "4x2", None)
            out[rec["cell"]] = rec
for mode in D.DB_MODES:
    rec = D.run_cell(f"db__{mode}", lambda m: D.build_db_cell(mode, m),
                     D.db_model_flops(mode), mesh, "4x2", None)
    out[rec["cell"]] = rec
# two cells again with every op computed, none answered from the memo
for arch, kind, b, s in (("xlstm-1.3b", "train", 8, 32),
                         ("qwen2-1.5b", "decode", 8, 64)):
    cfg = get_smoke_config(arch)
    cell = SP.ShapeCell(kind, s, b, kind)
    rec = D.run_cell(f"{arch}__{kind}__base__no_memo",
                     lambda m: D.build_lm_cell(arch, cell, m, "base", cfg=cfg),
                     D.model_flops(cfg, cell), mesh, "4x2", None, memo=False)
    out[rec["cell"]] = rec
print(json.dumps(out, default=str))
"""

_CELLS = {}


def _cells():
    if not _CELLS:
        got = _run(["-c", _CELLS_PROG])
        assert got.returncode == 0, (got.stdout[-3000:], got.stderr[-3000:])
        _CELLS.update(json.loads(got.stdout.strip().splitlines()[-1]))
    return _CELLS


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cells_run_at_a_fake_world_of_8(arch):
    cells = _cells()
    for kind in ("train", "prefill", "decode"):
        for variant in ("base", "opt"):
            rec = cells[f"{arch}__{kind}__{variant}"]
            assert rec["ok"], rec.get("traceback")
            assert rec["peak_bytes"] >= rec["state_and_input_bytes"] > 0
            assert rec["aten_flops"] > 0 and rec["fits_80gb"]
            assert rec["chips"] == 8 and rec["param_bytes"] > 0
            if kind == "decode":
                assert rec["decode_state_bytes"] > 0
            if kind == "train":
                assert rec["m_bytes"] == rec["v_bytes"] == rec["param_bytes"]
                assert rec["collectives"]["all_gather"] > 0
            if arch == "xlstm-1.3b" and kind != "decode":
                ops_ = rec["kernel_operations"]
                assert ops_.get("slstm", 0) > 0
                assert (ops_.get("slstm_backward", 0) > 0) == (
                    kind == "train")


def test_db_cells_run_at_a_fake_world_of_8():
    cells = _cells()
    kernels = {"flat": "l2_distance", "pq": "pq_adc", "bq": "hamming",
               "flat-rows": "l2_topk", "pq-rows": "pq_adc",
               "bq-rows": "hamming"}
    for mode, kernel in kernels.items():
        rec = cells[f"db__{mode}"]
        assert rec["ok"], rec.get("traceback")
        assert rec["kernel_operations"].get(kernel, 0) > 0, (mode, rec)


@pytest.mark.parametrize("cell", ["xlstm-1.3b__train", "qwen2-1.5b__decode"])
def test_the_memo_changes_no_record(cell):
    """A cell's peak and FLOPs with repeated ops answered from the memo
    equal those with every op computed."""
    cells = _cells()
    memo, plain = cells[f"{cell}__base"], cells[f"{cell}__base__no_memo"]
    assert memo["ok"] and plain["ok"], plain.get("traceback")
    assert memo["ops_answered_again"] > 0 == plain["ops_answered_again"]
    for key in ("peak_bytes", "aten_flops", "state_and_input_bytes",
                "kernel_operations", "collectives"):
        assert memo[key] == plain[key], key


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_a_meta_tensor_takes_the_meta_branch():
    before = (l2.launches, l2.topk_launches, slstm.launches,
              slstm.backward_launches, beam_gather.launches)
    ops.meta_operations.clear()
    q, x = _meta(7, 16), _meta(100, 16)
    assert ops.l2_distances(q, x).shape == (7, 100)
    assert ops.dot_distances(q, x).dtype == torch.float32
    d, i = ops.l2_topk(q, x, 5, mode="cosine")
    assert d.shape == i.shape == (7, 5) and i.dtype == torch.int64
    got = ops.pq_adc_distances(_meta(7, 8, 256), _meta(100, 8,
                                                       dtype=torch.uint8))
    assert got.shape == (7, 100) and got.dtype == torch.float32
    got = ops.hamming_distances(_meta(7, 8, dtype=torch.int32),
                                _meta(100, 8, dtype=torch.int32))
    assert got.shape == (7, 100) and got.dtype == torch.int32
    bsz, s, d_, heads = 2, 16, 64, 2
    gates = _meta(bsz, s, 4 * d_, dtype=torch.bfloat16).requires_grad_()
    r = _meta(4, heads, d_ // heads, d_ // heads).requires_grad_()
    b = _meta(4 * d_).requires_grad_()
    with torch.no_grad():
        h = ops.slstm_sequence(gates, r, b, n_heads=heads)
    assert h.shape == (bsz, s, d_) and h.dtype == torch.bfloat16
    h = ops.slstm_sequence(gates, r, b, n_heads=heads)
    h.float().sum().backward()
    assert gates.grad.shape == gates.shape and gates.grad.dtype == gates.dtype
    assert r.grad.shape == r.shape and b.grad.shape == b.shape
    assert before == (l2.launches, l2.topk_launches, slstm.launches,
                      slstm.backward_launches, beam_gather.launches)
    flat = 2.0 * 7 * 100 * 16
    assert ops.meta_operations["l2_distance"] == pytest.approx(
        flat + 2 * 107 * 16 + 3 * 700 + flat + 700)
    assert ops.meta_operations["l2_topk"] == pytest.approx(flat + 700)
    assert ops.meta_operations["pq_adc"] == 7 * 100 * 8
    assert ops.meta_operations["hamming"] == 7 * 100 * 8
    cell = 2.0 * bsz * s * 4 * d_ * (d_ // heads)
    assert ops.meta_operations["slstm"] == 2 * cell
    assert ops.meta_operations["slstm_backward"] == cell
    with pytest.raises(ValueError):
        ops.beam_gather_distances(_meta(2, 16), _meta(2, 4, dtype=torch.int32),
                                  _meta(100, 16))
