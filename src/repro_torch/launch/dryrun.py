"""Multi-pod dry run: build every (architecture × shape × mesh) cell on the
production meshes and run its step once on abstract tensors, recording
what each rank would hold, move and compute — the port of the JAX
package's ``repro.launch.dryrun``.

The reference lowers and compiles each cell for 256 or 512 virtual TPU
devices.  Here this process plays rank 0 of a fake process group of that
size (``launch.mesh.start_fake_world``: every collective returns at once)
over the production ``DeviceMesh``, and the state, the batch and every
activation are tensors on the meta device: shapes and dtypes, no storage,
no card.  The step is the port's own (``make_train_step``, ``forward``,
``make_serve_step`` on a placed model, ``distributed.search``), so each
cell runs the code a deployment runs, the kernels through their meta
branch (``kernels.ops``).  Per cell it records:

* each rank's bytes of params, m, v and decode state (``Placement``,
  ``models.model.placement_summary``);
* the step's peak of live tensor bytes on rank 0 (``StepCounters``: the
  state, the batch and every tensor the step makes, until it is freed) and
  whether it fits the H100's 80 GiB (``fits_80gb``);
* the collectives and their bytes (``Placement.counts``);
* the ``aten`` FLOPs (``FlopCounterMode``'s formulas) and the kernels'
  operations, which no flop counter sees (``kernels.ops.meta_operations``);
* model FLOPs (``6·N·D`` train, ``2·N·D`` prefill, ``2·N·batch`` decode,
  ``benchmarks/roofline.py``'s formulas);
* the policy's ``replicated_report()[:20]``, the wall seconds, and the
  error and traceback of a failure, which is recorded and counted.

There is no HLO, XLA cost analysis, roofline step time or TPU constant:
those come from XLA and a TPU.

    python -m repro_torch.launch.dryrun --list
    python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k \\
        --mesh single
    python -m repro_torch.launch.dryrun --mesh both --db --variant opt

One JSON a cell goes to ``--out``/<mesh>/<cell>.json (default
``chiprun_out/dryrun`` beside ``src/``); the process exits 1 when any cell
failed.  A process can hold one default group, so ``--mesh both`` runs
each mesh and LM cell (and each mesh's db cells) in a child process of its
own, as many at a time as the process may use cores.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..configs import arch_ids, get_config, get_smoke_config
from ..configs.quantixar_db import CONFIG as DB_CONFIG
from ..distributed import search as dsearch
from ..distributed.sharding import ShardingPolicy
from ..kernels import ops
from ..models import make_serve_step, make_train_step
from ..models.convert import placement as placement_of
from ..models.model import (Model, abstract_params, decode_leaves, forward,
                            place_decode_state, placement_summary)
from ..models.steps import TrainState
from ..optim import AdamWConfig, adamw
from . import specs as SP
from .mesh import make_production_mesh, mesh_axis_sizes, start_fake_world

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                       "..", "chiprun_out", "dryrun")

DB_MODES = ("flat", "pq", "bq",               # paper-faithful 2D baseline
            "flat-rows", "pq-rows", "bq-rows")  # rows-mode layout

#: the H100's device memory
CARD_BYTES = 80 * 2**30

# Megatron-SP where the reference measured a gain: qwen2, recurrentgemma,
# starcoder2, chameleon (and a loss on the qk-norm / MHA / MoE / enc-dec
# archs); the "opt" variant's per-arch layout choice, kept as is
SP_ARCHS = {"qwen2-1.5b", "starcoder2-15b", "recurrentgemma-9b",
            "chameleon-34b"}


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


# ---------------------------------------------------------------------------
# abstract placed state
# ---------------------------------------------------------------------------

def placed_abstract_params(cfg, policy, *, batch_split: bool = True
                           ) -> Model:
    """``abstract_params`` placed by ``policy``: each parameter a meta
    tensor of this rank's block, the ``Placement`` bound."""
    model = abstract_params(cfg)
    pl = placement_of(model, policy, batch_split=batch_split)
    for k in list(pl.shapes):
        owner, _, attr = k.rpartition(".")
        setattr(model.get_submodule(owner) if owner else model, attr,
                torch.nn.Parameter(torch.empty(pl.local_shape(k),
                                               device="meta")))
    pl.bind(model)
    return model


def _local_batch(policy, spec: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch spec (all of them where the batch
    axes do not divide the batch)."""
    shape = list(spec.shape)
    if policy.batch_spec(tuple(shape))[0] is not None:
        shape[0] //= policy.n_batch_shards
    return torch.empty(shape, dtype=spec.dtype, device="meta")


class Cell(NamedTuple):
    """A dry-run cell: ``step(*args)`` runs it; ``policy`` places it;
    ``cfg`` is the config after the cell's overrides (None for a db
    cell)."""
    step: Any
    args: tuple
    policy: Optional[ShardingPolicy]
    cfg: Any


def cell_config(arch: str, cell: SP.ShapeCell, mesh, variant: str = "base",
                cfg=None):
    """(config, policy) of an LM cell by the reference's rules
    (``dryrun.py:61-97``): ``dp_only`` for the ssm family when the batch
    divides the mesh (opt), the batch axes pinned when they divide the
    batch, and the "opt" package (uniform-position decode, extent
    attention, bf16 weight gathers, gather MoE dispatch for tiny experts,
    Megatron-SP on ``SP_ARCHS`` in train cells, a 1,024 mLSTM chunk with
    bf16 carried state).  ``cfg``: the config to start from (default the
    arch's published one)."""
    cfg = cfg or get_config(arch)
    opt = variant == "opt"
    size = mesh.mesh.numel()
    dp_only = (opt and cfg.family == "ssm"
               and cell.global_batch % size == 0)
    policy = ShardingPolicy(mesh, shard_cache_seq=opt,
                            head_proj_model_only=opt, dp_only=dp_only)
    if cell.global_batch % policy.n_batch_shards == 0:
        cfg = cfg.with_overrides(batch_axes=tuple(policy.batch_axes))
    if opt:
        dispatch = ("gather" if cfg.moe_experts and cfg.d_ff < cfg.d_model
                    else cfg.moe_dispatch)
        cfg = cfg.with_overrides(
            decode_pos_mode="uniform", moe_dispatch=dispatch,
            attn_schedule="extent", bf16_weight_gather=True,
            sequence_parallel=(cell.kind == "train" and not dp_only
                               and arch in SP_ARCHS
                               and cell.seq_len % 16 == 0),
            mlstm_chunk=1024, mlstm_state_dtype="bfloat16")
    return cfg, policy


def build_lm_cell(arch: str, shape, mesh, variant: str = "base", *,
                  cfg=None) -> Cell:
    """The cell's step and its abstract (meta) arguments on ``mesh``, each
    rank's share of them: the placed train state and its rows of the batch
    (train), the placed params and rows (prefill: the next-token logits),
    the placed params, decode state and tokens (decode).  ``shape``: a
    name in ``specs.SHAPES`` or a ``ShapeCell`` (a cut batch); ``cfg``: the
    config to start from (a cut depth)."""
    cell = SP.SHAPES[shape] if isinstance(shape, str) else shape
    cfg, policy = cell_config(arch, cell, mesh, variant, cfg)
    if cell.kind == "train":
        from .train import _batch_groups
        batch = {k: _local_batch(policy, v)
                 for k, v in SP.lm_train_specs(cfg, cell).items()}
        split = batch["tokens"].shape[0] != cell.global_batch
        model = placed_abstract_params(cfg, policy, batch_split=split)
        state = TrainState(model=model,
                           opt=adamw.init(dict(model.named_parameters())))
        groups = _batch_groups(mesh, policy) if split else None
        step = make_train_step(cfg, AdamWConfig(total_steps=10_000),
                               groups=groups)
        return Cell(step, (state, batch), policy, cfg)
    model = placed_abstract_params(cfg, policy)
    if cell.kind == "prefill":
        batch = {k: _local_batch(policy, v)
                 for k, v in SP.lm_train_specs(cfg, cell).items()
                 if k not in ("targets", "segment_ids")}

        def prefill_step(params, batch):
            with torch.no_grad():
                logits, _ = forward(params, batch, cfg, last_only=True)
            return logits[:, -1, :]            # next-token logits only

        return Cell(prefill_step, (model, batch), policy, cfg)
    if cell.kind == "decode":
        tokens, state = SP.lm_decode_specs(cfg, cell)
        state = place_decode_state(state, cfg, model.placement)
        return Cell(make_serve_step(cfg), (model, state,
                                           _local_batch(policy, tokens)),
                    policy, cfg)
    raise ValueError(cell.kind)


def build_db_cell(mode: str, mesh) -> Cell:
    """A ``quantixar-db`` search cell: the search of
    ``distributed.search`` in the mode's layout (bare names "dims", the
    paper-faithful baseline; ``-rows`` the rows layout) and this rank's
    blocks of the corpus (or codes) and queries (or LUT, query words)."""
    k = DB_CONFIG.k
    base, _, layout = mode.partition("-")
    layout = layout or "dims"
    sizes = mesh_axis_sizes(mesh)
    size = mesh.mesh.numel()
    rows_mult = size if layout == "rows" else size // sizes.get("model", 1)
    sp = SP.db_specs(DB_CONFIG, base, row_multiple=rows_mult)
    if base == "flat":
        fn = dsearch.make_flat_search(mesh, k=k, metric=DB_CONFIG.metric,
                                      dim=DB_CONFIG.dim, mode=layout)
        arrays, dim = (sp["corpus"], sp["queries"]), DB_CONFIG.dim
    elif base == "pq":
        fn = dsearch.make_pq_search(mesh, k=k, m_subspaces=DB_CONFIG.pq_m,
                                    mode=layout)
        arrays, dim = (sp["codes"], sp["lut"]), DB_CONFIG.pq_m
    elif base == "bq":
        words = DB_CONFIG.bq_bits // 32
        fn = dsearch.make_hamming_search(mesh, k=k, words=words,
                                         mode=layout)
        arrays = tuple(a.view(torch.int32) for a in
                       (sp["codes"], sp["q_codes"]))
        dim = words
    else:
        raise ValueError(mode)
    # the rank's own copies (a block can be a view of the whole array)
    block = dsearch.local_block(arrays[0], mesh, layout, dim=dim).clone()
    queries = dsearch.local_block(arrays[1], mesh, layout, rows=False,
                                  dim=dim).clone()
    return Cell(fn, (block, queries), None, None)


# ---------------------------------------------------------------------------
# model FLOPs (the useful work)
# ---------------------------------------------------------------------------

def model_flops(cfg, cell: SP.ShapeCell) -> float:
    """6·N·D (train), 2·N·D (prefill), 2·N·batch (decode) over the active
    parameters (``benchmarks/roofline.py``'s formulas)."""
    n_active = cfg.active_param_count()
    tokens = cell.global_batch * cell.seq_len
    if cell.kind == "train":
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * cell.global_batch


def db_model_flops(mode: str) -> float:
    n, q, d = DB_CONFIG.n_vectors, DB_CONFIG.query_batch, DB_CONFIG.dim
    base = mode.partition("-")[0]
    if base == "flat":
        return 2.0 * q * n * d
    if base == "pq":
        return 1.0 * q * n * DB_CONFIG.pq_m
    return 3.0 * q * n * (DB_CONFIG.bq_bits // 32)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

class StepCounters:
    """What one abstract step does, seen from below autograd: a dispatch
    mode over every ``aten`` op of the step (the backward's too) that
    keeps

    * ``now`` / ``peak``: the live tensor bytes (every storage of
      ``existing`` and of each op's outputs, counted once — views share
      it — until it is freed) and their peak;
    * ``flops``: ``FlopCounterMode``'s count (its formula registry, the
      same rule: products and convolutions);

    and answers a functional op it has already answered (no output written
    in place or aliasing an input; meta tensors of the same sizes, strides
    and dtypes, wherever they start in their storage; the same other
    arguments) with fresh empty tensors of the
    recorded sizes, strides and dtypes, and the recorded FLOPs.  The meta
    device computes those in Python (``torch._refs``), which is most of a
    dry run's time: a chunked attention or an mLSTM chunk loop repeats one
    shape thousands of times.  ``memo=False`` computes every op (the same
    records, slower: ``tests/test_torch_dryrun.py`` holds one to the
    other)."""

    def __init__(self, *existing: torch.Tensor, memo: bool = True):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        from torch.utils.flop_counter import flop_registry

        live: Dict[int, int] = {}
        answers: Dict[Any, Any] = {}
        pure: Dict[Any, bool] = {}
        self.now = self.peak = self.flops = 0
        self.hits = self.misses = 0
        outer = self

        def add(t: torch.Tensor) -> None:
            st = t.untyped_storage()
            key = st._cdata
            if key in live:
                return
            live[key] = st.nbytes()
            outer.now += live[key]
            outer.peak = max(outer.peak, outer.now)
            weakref.finalize(st, drop, key)

        def drop(key: int) -> None:
            outer.now -= live.pop(key, 0)

        def functional(func) -> bool:
            if func not in pure:
                schema = func._schema
                pure[func] = (
                    func.namespace == "aten" and not schema.is_mutable
                    and len(schema.returns) > 0
                    and all(r.alias_info is None
                            and str(r.type) == "Tensor"
                            for r in schema.returns))
            return pure[func]

        plain = (int, float, bool, str, type(None), torch.dtype,
                 torch.device, torch.memory_format, torch.layout)

        def part(x):
            """A hashable stand-in for one argument, or None where the
            argument rules the op out."""
            if isinstance(x, torch.Tensor):
                if x.device.type != "meta":
                    return None
                return (x.shape, x.stride(), x.dtype)
            if isinstance(x, plain):
                return (type(x), x)
            if isinstance(x, (list, tuple)):
                inner = tuple(part(y) for y in x)
                return None if None in inner else (type(x), inner)
            return None

        def key_of(func, args, kwargs):
            parts = part(args)
            if parts is None:
                return None
            if kwargs:
                kw = part(tuple(kwargs.items()))
                if kw is None:
                    return None
                return (func, parts, kw)
            return (func, parts)

        def count(func, args, kwargs, out) -> int:
            formula = flop_registry.get(func._overloadpacket)
            return 0 if formula is None else formula(*args, **kwargs,
                                                     out_val=out)

        for t in existing:
            add(t)

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                key = key_of(func, args, kwargs) \
                    if memo and functional(func) else None
                hit = answers.get(key) if key is not None else None
                if hit is not None:
                    outer.hits += 1
                    metas, flops = hit
                    made = [torch.empty_strided(sz, st, dtype=dt,
                                                device="meta")
                            for sz, st, dt in metas]
                    out = made[0] if len(made) == 1 else tuple(made)
                else:
                    out = func(*args, **kwargs)
                    flops = count(func, args, kwargs, out)
                    if key is not None:
                        outer.misses += 1
                        outs = out if isinstance(out, tuple) else (out,)
                        ins = {t.untyped_storage()._cdata
                               for t in tree_leaves((args, kwargs))
                               if isinstance(t, torch.Tensor)}
                        # an op that returns an input's storage (a view the
                        # schema does not declare) is never answered here
                        if not any(t.untyped_storage()._cdata in ins
                                   for t in outs):
                            answers[key] = ([(tuple(t.shape), t.stride(),
                                              t.dtype) for t in outs],
                                            flops)
                outer.flops += flops
                if isinstance(out, torch.Tensor):
                    add(out)
                else:
                    for t in tree_leaves(out):
                        if isinstance(t, torch.Tensor):
                            add(t)
                return out

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, Model):
        yield from obj.parameters()
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _holdings(cell: Cell) -> dict:
    """Each rank's bytes of params, m, v and decode state, and the
    placement's summary."""
    args = cell.args
    model = args[0].model if isinstance(args[0], TrainState) else args[0]
    if not isinstance(model, Model):
        return {"input_bytes": _nbytes(_tensors(args))}
    out = {"param_bytes": _nbytes(model.parameters())}
    if isinstance(args[0], TrainState):
        summary = placement_summary(model, args[0].opt)
        out.update(m_bytes=summary["m_bytes"], v_bytes=summary["v_bytes"],
                   placement=summary)
    if len(args) == 3:             # decode: (params, state, tokens)
        out["decode_state_bytes"] = _nbytes(
            t for *_, t in decode_leaves(args[1], cell.cfg))
    return out


def run_cell(name: str, builder, mflops: float, mesh, tag: str,
             out_dir: Optional[str], memo: bool = True) -> dict:
    """Build the cell, run its step once under the counters, record
    (``memo=False``: every op computed, none answered from the memo)."""
    rec = {"cell": name, "mesh": tag, "chips": mesh.mesh.numel(),
           "mesh_shape": dict(mesh_axis_sizes(mesh))}
    t0 = time.perf_counter()
    try:
        cell = builder(mesh)
        t1 = time.perf_counter()
        rec.update(_holdings(cell))
        pl = getattr(next((a for a in (
            cell.args[0].model if isinstance(cell.args[0], TrainState)
            else cell.args[0],) if isinstance(a, Model)), None),
            "placement", None)
        before = dict(pl.counts) if pl is not None else {}
        ops.meta_operations.clear()
        counters = StepCounters(*_tensors(cell.args), memo=memo)
        base = counters.now
        with counters:
            cell.step(*cell.args)
        rec.update({
            "ok": True, "build_s": t1 - t0,
            "step_s": time.perf_counter() - t1,
            "state_and_input_bytes": base,
            "peak_bytes": counters.peak,
            "peak_gib": counters.peak / 2**30,
            "fits_80gb": counters.peak < CARD_BYTES,
            "aten_flops": counters.flops,
            "ops_answered_again": counters.hits,
            "kernel_operations": dict(ops.meta_operations),
            "model_flops": mflops,
            "collectives": ({k: v - before.get(k, 0)
                             for k, v in pl.counts.items()}
                            if pl is not None else {}),
        })
        if cell.policy is not None:
            rec["replicated_params"] = cell.policy.replicated_report()[:20]
    except Exception as e:  # record failures: they are bugs to fix
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    rec["wall_s"] = time.perf_counter() - t0
    if out_dir:
        os.makedirs(os.path.join(out_dir, tag), exist_ok=True)
        with open(os.path.join(out_dir, tag, f"{name}.json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    if rec["ok"]:
        extra = (f"peak/rank={rec['peak_gib']:.3f}GiB "
                 f"fits80={rec['fits_80gb']} "
                 f"gather={rec['collectives'].get('gather_bytes', 0)}B "
                 f"wall={rec['wall_s']:.1f}s")
    else:
        extra = rec["error"][:200]
    print(f"[{'OK ' if rec['ok'] else 'FAIL'}] {tag} {name}: {extra}",
          flush=True)
    return rec


def iter_cells(archs, shapes, db: bool, get=get_config):
    for arch in archs:
        cfg = get(arch)
        for shape in shapes:
            ok, why = SP.cell_supported(cfg, shape)
            yield arch, shape, ok, why
    if db:
        for mode in DB_MODES:
            yield "quantixar-db", mode, True, ""


def run_mesh(multi_pod: bool, archs, shapes, db: bool, variant: str,
             out_dir: str) -> int:
    """Every cell on one production mesh, in this process (which starts
    the fake world of its size); returns the number of failures."""
    start_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    tag = _mesh_tag(multi_pod)
    suffix = "__opt" if variant == "opt" else ""
    n_fail, t0 = 0, time.perf_counter()
    for arch, shape, ok, why in iter_cells(archs, shapes, db):
        name = f"{arch}__{shape}{suffix}"
        if not ok:
            os.makedirs(os.path.join(out_dir, tag), exist_ok=True)
            with open(os.path.join(out_dir, tag, f"{name}.json"), "w") as f:
                json.dump({"cell": name, "mesh": tag, "ok": True,
                           "skipped": why}, f, indent=1)
            print(f"[SKIP] {tag} {name}: {why}", flush=True)
            continue
        if arch == "quantixar-db":
            rec = run_cell(name, lambda m, mode=shape: build_db_cell(mode, m),
                           db_model_flops(shape), mesh, tag, out_dir)
        else:
            rec = run_cell(
                name, lambda m, a=arch, s=shape: build_lm_cell(
                    a, s, m, variant=variant),
                model_flops(get_config(arch), SP.SHAPES[shape]), mesh, tag,
                out_dir)
        n_fail += 0 if rec["ok"] else 1
    print(f"{tag}: {time.perf_counter() - t0:.1f} s, failures: {n_fail}",
          flush=True)
    return n_fail


def predict(spec: dict) -> dict:
    """One cell of any mesh and batch, in this process: ``spec`` holds
    ``arch``, ``kind``, ``batch``, ``seq`` (the cache length for decode),
    ``mesh`` (the axis sizes, data then model), ``variant``, and optional
    ``smoke`` (the smoke config) and ``overrides`` (config fields, e.g. a
    cut depth).  Starts a fake world of the mesh's size; returns the
    record (``peak_bytes`` is rank 0's peak: the prediction a run on cards
    is held to)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(spec["mesh"])
    world = 1
    for n in shape:
        world *= n
    start_fake_world(world)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=(
        ("pod", "data", "model") if len(shape) == 3 else ("data", "model")))
    base = (get_smoke_config if spec.get("smoke") else get_config)(
        spec["arch"]).with_overrides(**spec.get("overrides", {}))
    cell = SP.ShapeCell("custom", spec["seq"], spec["batch"], spec["kind"])

    def builder(m):
        return build_lm_cell(spec["arch"], cell, m,
                             spec.get("variant", "base"), cfg=base)

    return run_cell(f"{spec['arch']}__{spec['kind']}", builder,
                    model_flops(base, cell), mesh,
                    "x".join(map(str, shape)), spec.get("out"))


def _run_children(args, archs, shapes) -> int:
    """Both meshes' cells in child processes (a process holds one default
    group): one a mesh and LM cell, and one a mesh for the db cells, as
    many at a time as this process may use cores.  Returns 1 when any
    failed."""
    common = ["--variant", args.variant, "--out", args.out]
    groups = [["--arch", a, "--shape", sh] for a in archs for sh in shapes]
    if args.db or args.db_only:
        groups.append(["--db-only"])
    cmds = [[sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
             m] + g + common for m in ("single", "multi") for g in groups]
    width = len(os.sched_getaffinity(0))
    t0, codes, running = time.perf_counter(), [], []
    while cmds or running:
        while cmds and len(running) < width:
            running.append(subprocess.Popen(cmds.pop(0)))
        for p in list(running):
            if p.poll() is not None:
                codes.append(p.returncode)
                running.remove(p)
        time.sleep(0.2)
    print(f"dry-run complete in {time.perf_counter() - t0:.1f} s; "
          f"child processes failed: {sum(c != 0 for c in codes)}",
          flush=True)
    return 1 if any(codes) else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all",
                    help="arch id, comma list, or 'all'")
    ap.add_argument("--shape", default="all",
                    help="shape name, comma list, or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--db", action="store_true",
                    help="also run quantixar-db cells")
    ap.add_argument("--db-only", action="store_true")
    ap.add_argument("--variant", default="base", choices=["base", "opt"],
                    help="opt = the reference's beyond-baseline package; "
                         "records get an __opt suffix")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--predict", default=None,
                    help="a JSON cell spec (``predict``): run that one cell "
                         "and print its record as the last line")
    args = ap.parse_args(argv)

    if args.predict:
        rec = predict(json.loads(args.predict))
        print(json.dumps(rec, default=str))
        return 0 if rec["ok"] else 1

    archs = arch_ids() if args.arch == "all" else args.arch.split(",")
    shapes = list(SP.SHAPES) if args.shape == "all" else args.shape.split(",")
    if args.db_only:
        archs, shapes = [], []

    if args.list:
        for arch, shape, ok, why in iter_cells(archs, shapes,
                                               args.db or args.db_only):
            print(f"{arch:24s} {shape:12s} {'run' if ok else why}")
        return 0

    if args.mesh == "both":
        return _run_children(args, archs, shapes)

    n_fail = run_mesh(args.mesh == "multi", archs, shapes,
                      args.db or args.db_only, args.variant, args.out)
    print(f"\ndry-run complete; failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
