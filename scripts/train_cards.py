#!/usr/bin/env python3
"""Training with the state placed by the sharding policy across the cards
of one host, one process a card.

Run from the repository root on a host with 4 cards:

    python3 scripts/train_cards.py                      # world 4, NCCL
    python3 scripts/train_cards.py --device cpu --smoke   # 4 gloo ranks

It starts ``--world`` processes (rank r on card r) joined by NCCL (gloo with
``--device cpu``) at tcp://localhost on a free port, and runs three parts
through ``launch.train.train`` (``--parts`` picks some):

* ``a`` agreement: xlstm-1.3b at full width and one unit of 8 layers,
  qwen3-4b at full width and 4 of its 36 layers, fp32, 2 steps of 8 x 256
  tokens; the placed run on a (world, 1) and a (world / 2, 2) mesh against
  the replicated data-parallel step on the same cards with the same rows a
  rank (every rank the whole model, the gradients averaged over the ranks
  that split the batch by one all_reduce).  Losses and grad norms within
  ``DP_TOL`` = 1e-5 relative, every parameter after the 2 steps (gathered
  whole) within 1e-5 absolute; beside it the share of parameter elements
  within 1e-5, the element that parts the runs most with both runs'
  AdamW arithmetic on it step by step (``adamw_trace``: gradient, clipping
  scale, m, v, m̂ / (√v̂ + ε), update), and the two replicated runs held
  to each other (their batch layouts alone).
* ``b`` qwen3-4b at its full size (36 layers, bf16 activations with
  ``bf16_weight_gather``, fp32 masters, remat) on (world, 1): ``--steps``
  steps of 8 x 2,048 ``lm_batches`` tokens; every loss finite, the last
  below the first.
* ``c`` xlstm-1.3b at its full size on (world, 1) and (world / 2, 2), as b
  (the config's own dtype settings, as ``chip_smoke.py`` phase L1 runs it).

Each b / c run prints the median step (host clock around the step and CUDA
events, steps 2..), tokens/s, each card's peak GiB, each rank's B8 / B8ᵀ
launches, the placement (``models.model.placement_summary``) and the
step's collectives and their bytes on rank 0.  Results go to stdout (rank 0, one JSON line
each) and to ``chiprun_out/train_cards.jsonl``.  Any disagreement or
failed check exits non-zero.  ``--smoke`` runs the smoke configs at 8 x 32
(a check of the script, on gloo here).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

TIMEOUT_S = 300        # a collective that waits longer fails the rank
WALL_S = 1400          # the whole run
DP_TOL = 1e-5
AGREE_B, AGREE_S, AGREE_STEPS = 8, 256, 2
AGREE_LAYERS = {"xlstm-1.3b": 8, "qwen3-4b": 4}
FULL_B, FULL_S = 8, 2048


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_rank(rank: int, args) -> None:
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import chip_smoke as cs
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch import train as train_mod
    from repro_torch.models import init_train_state, make_train_step
    from repro_torch.models.convert import decay_mask
    from repro_torch.models.model import placement_summary
    from repro_torch.optim import adamw

    on_card = args.device == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
    dev = torch.device(f"cuda:{rank}" if on_card else "cpu")
    dist.init_process_group(
        "nccl" if on_card else "gloo",
        init_method=f"tcp://localhost:{args.port}", rank=rank,
        world_size=args.world, device_id=dev if on_card else None,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    world = args.world
    shapes = {"rows": (world, 1), "2d": (world // 2, 2)}
    get = get_smoke_config if args.smoke else get_config
    out_f = open(os.path.join(ROOT, "chiprun_out", "train_cards.jsonl"),
                 "a") if rank == 0 else None
    failed = []

    def log(obj):
        if rank == 0:
            line = json.dumps(obj, default=float)
            print(line, flush=True)
            out_f.write(line + "\n")
            out_f.flush()

    def check(cond, msg):
        if not cond:
            failed.append(msg)
            log({"check_failed": msg})

    def mesh_of(shape):
        return init_device_mesh(dev.type, shape,
                                mesh_dim_names=("data", "model"))

    def sync():
        if on_card:
            torch.cuda.synchronize()
        dist.barrier()

    def peak_reset():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peaks():
        gib = (torch.cuda.max_memory_allocated() / 2**30 if on_card
               else 0.0)
        got = [None] * world
        dist.all_gather_object(got, gib)
        return got

    def whole_params(model):
        """{port tensor name: the whole parameter} on the card (a placed
        model's blocks gathered, one tensor at a time)."""
        pl = getattr(model, "placement", None)
        return {k: p.detach().clone() if pl is None else pl.full(k, p)
                for k, p in model.named_parameters()}

    def compare(got_m, got_p, want_m, want_p):
        loss_rel = max(abs(g[0] / w[0] - 1) for g, w in zip(got_m, want_m))
        gnorm_rel = max(abs(g[1] / w[1] - 1) for g, w in zip(got_m, want_m))
        worst, worst_d, worst_i, within, n = None, -1.0, 0, 0, 0
        for k, want in want_p.items():
            d = (got_p[k] - want).abs().reshape(-1)
            i = int(d.argmax())
            if float(d[i]) > worst_d:
                worst, worst_d, worst_i = k, float(d[i]), i
            within += int((d <= DP_TOL).sum())
            n += d.numel()
        return {"loss_rel": loss_rel, "grad_norm_rel": gnorm_rel,
                "param_max_abs": worst_d, "param_worst": worst,
                "param_worst_index": worst_i,
                "param_share_within_tol": within / n}

    class record_steps:
        """Within it, each AdamW step of this process keeps its gradients
        (pre-clip, a placed model's blocks), the norm it clipped by and
        (``first_params``) the parameters before the first step."""

        def __init__(self, first_params=False):
            self.steps, self.p0, self.first = [], None, first_params

        def __enter__(self):
            self.orig = orig = adamw.apply_updates

            def spy(params, grads, state, cfg, **kw):
                if self.first and self.p0 is None:
                    self.p0 = {k: p.detach().clone()
                               for k, p in params.items()}
                rec = {k: g.detach().clone() for k, g in grads.items()}
                out = orig(params, grads, state, cfg, **kw)
                self.steps.append((rec, out[2].detach().clone()))
                return out
            adamw.apply_updates = spy
            return self

        def __exit__(self, *exc):
            adamw.apply_updates = self.orig

    def adamw_trace(p0, grads, norms, opt_cfg, decay):
        """One element's AdamW steps replayed through ``apply_updates`` on
        one-element tensors (elementwise f32, so the same bits as the
        run's): per step the gradient, the clipping scale, m, v, the
        normalised step m̂ / (√v̂ + ε) and the parameter after it."""
        p = p0.reshape(1).clone()
        state = adamw.init({"x": p})
        rows = []
        for g, norm in zip(grads, norms):
            before = p.clone()
            _, state, _ = adamw.apply_updates(
                {"x": p}, {"x": g.reshape(1)}, state, opt_cfg,
                decay={"x": decay}, norm=norm)
            lr = float(adamw.make_schedule(opt_cfg)(state.step))
            step_f = float(state.step)
            m, v = float(state.m["x"]), float(state.v["x"])
            rows.append({
                "grad": float(g), "clip_scale": float(torch.clamp_max(
                    opt_cfg.grad_clip_norm / (norm + 1e-9), 1.0)),
                "m": m, "v": v, "lr": lr,
                # m̂ / (√v̂ + ε) in f64 from the f32 m and v
                "normalised_step": (m / (1 - opt_cfg.b1 ** step_f)) / (
                    math.sqrt(v / (1 - opt_cfg.b2 ** step_f))
                    + opt_cfg.eps),
                "update": float(before - p), "param": float(p)})
        return rows

    def worst_trace(cmp, rep, rep_steps, placed, pl_steps, got_p, want_p,
                    opt_cfg, decay):
        """Both runs' ``adamw_trace`` of the element that parts them most
        (every rank takes part in the gathers), and whether each replay
        ends on its run's parameter."""
        k, i = cmp["param_worst"], cmp["param_worst_index"]
        pl = placed.placement
        rep_g = [st[0][k].reshape(-1)[i] for st in rep_steps]
        pl_g = [pl.full(k, st[0][k]).reshape(-1)[i] for st in pl_steps]
        p0 = rep.p0[k].reshape(-1)[i]
        out = {"tensor": k, "index": i, "eps": opt_cfg.eps}
        for tag, gs, steps, final in (
                ("replicated", rep_g, rep_steps, want_p[k]),
                ("placed", pl_g, pl_steps, got_p[k])):
            rows = adamw_trace(p0, gs, [st[1] for st in steps], opt_cfg,
                               decay[k])
            out[tag] = rows
            out[f"{tag}_replay_exact"] = (
                rows[-1]["param"] == float(final.reshape(-1)[i]))
        return out

    def replicated(cfg, steps, b, s, shape):
        """The replicated data-parallel run: every rank the whole model and
        the rows of the batch a placed run on a ``shape`` mesh gives it,
        the gradients averaged over the ranks that split the batch
        (``_average_grads``)."""
        mesh = mesh_of(shape)
        policy = ShardingPolicy(mesh)
        rows = train_mod._batch_rows(mesh, policy, b)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        state = init_train_state(cfg, generator=gen, device=dev)
        group = (train_mod._batch_group(mesh, policy)
                 if rows != slice(0, b) else None)
        step_fn = make_train_step(cfg, train_mod.opt_config(steps, args.lr),
                                  group=group)
        data = lm_batches(cfg.vocab_size, b, s, seed=0)
        metrics = []
        with record_steps(first_params=True) as rec:
            for _ in range(steps):
                state, m = step_fn(state, train_mod.rank_batch(
                    next(data), rows, cfg, s, dev))
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return metrics, whole_params(state.model), rec

    # ---------------------------------------------------------------- a
    if "a" in args.parts:
        for arch, layers in AGREE_LAYERS.items():
            cfg = get(arch)
            cfg = cfg.with_overrides(
                dtype="float32",
                n_layers=(len(cfg.block_pattern) if args.smoke else layers))
            b, s = AGREE_B, (32 if args.smoke else AGREE_S)
            opt_cfg = train_mod.opt_config(AGREE_STEPS, args.lr)
            t0 = time.perf_counter()
            res = {"part": "a", "arch": arch, "n_layers": cfg.n_layers,
                   "dtype": "float32", "batch": b, "seq": s}
            first = None
            for tag, shape in shapes.items():
                want_m, want_p, rep = replicated(cfg, AGREE_STEPS, b, s,
                                                 shape)
                with record_steps() as placed_rec:
                    out = train_mod.train(cfg, steps=AGREE_STEPS,
                                          global_batch=b, seq_len=s,
                                          lr=args.lr, mesh=mesh_of(shape),
                                          device=dev, log_every=1)
                model = out["state"].model
                got_m = [(m["loss"], m["grad_norm"]) for m in out["metrics"]]
                got_p = whole_params(model)
                key = f"{shape[0]}x{shape[1]}"
                cmp = compare(got_m, got_p, want_m, want_p)
                res[f"placed_{key}"] = {
                    "losses": [m[0] for m in got_m],
                    "grad_norms": [m[1] for m in got_m], **cmp,
                    "replicated_losses": [m[0] for m in want_m],
                    "replicated_grad_norms": [m[1] for m in want_m],
                    "worst_element": worst_trace(
                        cmp, rep, rep.steps, model, placed_rec.steps, got_p,
                        want_p, opt_cfg, decay_mask(model))}
                check(cmp["loss_rel"] <= DP_TOL
                      and cmp["grad_norm_rel"] <= DP_TOL
                      and cmp["param_max_abs"] <= DP_TOL,
                      f"a {arch} {shape}: {cmp}")
                del out, model, got_p, rep, placed_rec
                if first is None:
                    first = (want_m, want_p)
                else:
                    # how far the batch layouts alone (b / world rows a
                    # rank, or b / (world / 2)) part two replicated runs:
                    # the order of the fp32 sums in products of other
                    # shapes, carried on by AdamW
                    res["replicated_rows_vs_2d"] = compare(
                        want_m, want_p, *first)
                del want_p
            res["seconds"] = time.perf_counter() - t0
            log(res)
            del first
            if on_card:
                torch.cuda.empty_cache()

    # ------------------------------------------------------------- b, c
    def full_run(part, arch, shape, **over):
        cfg = get(arch).with_overrides(**over)
        b, s = FULL_B, (32 if args.smoke else FULL_S)
        mesh = mesh_of(shape)
        counters = cs.Counters()
        times = []
        sync()
        peak_reset()
        counters.reset()
        t0 = time.perf_counter()
        timer = (cs.step_timer(torch, times) if on_card
                 else _host_step_timer(train_mod, times))
        with timer:
            out = train_mod.train(cfg, steps=args.steps, global_batch=b,
                                  seq_len=s, lr=args.lr, mesh=mesh,
                                  device=dev)
        secs = time.perf_counter() - t0
        launches = counters.read()
        state = out["state"]
        pl = state.model.placement
        losses = [m["loss"] for m in out["metrics"]]
        check(len(losses) == args.steps and all(
            math.isfinite(x) for x in losses), f"{part} {arch}: {losses}")
        check(losses[-1] < losses[0], f"{part} {arch}: the loss did not "
              f"fall: {losses}")
        step_launches = [None] * world
        dist.all_gather_object(step_launches, {
            "slstm": launches["slstm"],
            "slstm_backward": launches["slstm_backward"]})
        wall = statistics.median(t for t, _ in times[1:])
        event = statistics.median(e for _, e in times[1:])
        res = {"part": part, "arch": arch, "mesh": list(shape),
               "n_layers": cfg.n_layers, "dtype": cfg.dtype,
               "bf16_weight_gather": cfg.bf16_weight_gather,
               "steps": args.steps, "batch": b, "seq": s,
               "losses": losses,
               "grad_norms": [m["grad_norm"] for m in out["metrics"]],
               "step_wall_ms": wall * 1e3, "step_event_ms": event,
               "step_wall_ms_all": [t * 1e3 for t, _ in times],
               "tokens_per_s": b * s / wall,
               "peak_gib_per_card": peaks(),
               "launches_per_rank": step_launches,
               "placement": placement_summary(state.model, state.opt),
               "collectives_rank0": dict(pl.counts),
               "train_s": secs}
        log(res)
        del out, state
        return res

    if "b" in args.parts:
        full_run("b", "qwen3-4b", shapes["rows"], bf16_weight_gather=True)
    if "c" in args.parts:
        for shape in shapes.values():
            full_run("c", "xlstm-1.3b", shape)

    sync()
    dist.destroy_process_group()
    if out_f:
        out_f.close()
    if failed:
        raise SystemExit(f"train_cards: {len(failed)} checks failed")


class _host_step_timer:
    """``chip_smoke.step_timer`` without the card: host clock only (the
    event column repeats it)."""

    def __init__(self, train_mod, times):
        self.mod, self.times = train_mod, times

    def __enter__(self):
        self.orig = self.mod.make_train_step
        times, orig = self.times, self.orig

        def timed(*a, **kw):
            fn = orig(*a, **kw)

            def step(state, batch):
                t0 = time.perf_counter()
                out = fn(state, batch)
                dt = time.perf_counter() - t0
                times.append((dt, dt * 1e3))
                return out
            return step

        self.mod.make_train_step = timed

    def __exit__(self, *exc):
        self.mod.make_train_step = self.orig


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--parts", default="abc")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs at 8 x 32 (checks the script)")
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    if args.world % 2 or args.world < 2:
        print("train_cards: --world must be even", file=sys.stderr)
        return 2
    if args.device == "cuda" and torch.cuda.device_count() < args.world:
        print(f"train_cards: {torch.cuda.device_count()} cards for "
              f"--world {args.world}", file=sys.stderr)
        return 2
    import chip_smoke as cs
    if args.device == "cuda":
        print(cs.card_line(), flush=True)
        from repro_torch.kernels import _build
        _build.build(["slstm", "slstm_backward"])   # before the ranks load
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    args.port = free_port()
    ctx = mp.start_processes(run_rank, args=(args,), nprocs=args.world,
                             join=False, start_method="spawn")
    t0 = time.perf_counter()
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > WALL_S:
                raise TimeoutError("the ranks did not finish in time")
    except mp.ProcessRaisedException as e:
        print(f"train_cards: a rank failed: {e}", file=sys.stderr)
        return 1
    except mp.ProcessExitedException as e:
        print(f"train_cards: a rank exited: {e}", file=sys.stderr)
        return 1
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
