#!/usr/bin/env python3
"""Serving with the model and the decode state placed by the sharding
policy across the cards of one host, one process a card.

Run from the repository root on a host with 4 cards:

    python3 scripts/serve_cards.py                      # world 4, NCCL
    python3 scripts/serve_cards.py --device cpu --smoke   # 4 gloo ranks

It starts ``--world`` processes (``scripts/train_cards.py``'s launcher)
and serves mixtral-8x7b and chameleon-34b through the dry run's cell
builder (``launch.dryrun.cell_config``: the "base" cell on a (world, 1)
mesh, the "opt" cell, whose KV caches split their slots over ``model``
(``shard_cache_seq``), on (world / 2, 2)), the parameters placed as a
train state is (``init_params_placed``) and the decode state by
``serve_state_spec`` (``init_decode_state(placement=...)``):

* ``agree``: 4 layers of each at full width in fp32: a prefill of 2 x 128
  tokens (``forward``) and 32 teacher-forced decode steps over a 256-slot
  cache on the placed model against the whole model on the same card
  (every rank builds both from one seed and holds its rows): logits
  within ``AGREE_TOL`` x the largest |logit|, argmax equal; every leaf the
  policy replicates over ``model`` equal on every ``model`` rank.  The
  decode starts at ``start_pos``, so its steps straddle the cache's
  middle: under ``shard_cache_seq`` each ``model`` rank's block holds
  tokens (checked) and the ranks' partial softmax sums merge live slots.
* ``full``: every layer (mixtral 32, 46.70 B parameters; chameleon 48,
  34.29 B), bf16 activations with ``bf16_weight_gather``: a prefill of 2 x
  2,048, then decode at batch 8 over a 32,768-slot cache (the decode_32k
  cell's cache, its batch cut from 128 so that four cards hold it): 64
  teacher-forced steps, then 32 generated, from ``start_pos`` as in
  ``agree``.  It prints the prefill tokens/s, the median decode step
  (host clock, synchronised), every id in [0, V), and each card's peak
  GiB of the prefill and of the decode beside the dry run's prediction
  for the same cell (``launch.dryrun --predict``, a child process on the
  host's CPU), their ratio within ``PEAK_RATIO``.

The ranks' allocator takes expandable segments (``ALLOC_CONF``).  Results
go to stdout (rank 0, one JSON line each) and to
``chiprun_out/serve_cards.jsonl``; a failed check exits non-zero.
``--smoke`` runs the smoke configs at small sizes on gloo (a check of the
script).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT,
                os.path.join(ROOT, "scripts")]

import train_cards  # noqa: E402  (the launcher)

TIMEOUT_S = 600        # a collective that waits longer fails the rank
# the ranks' allocator: at (2, 2) chameleon-34b's decode (62 GiB live a
# card) ran out of memory with 15.6 GiB reserved but unallocated in split
# blocks under the default one
ALLOC_CONF = "expandable_segments:True"
WALL_S = 900
ARCHS = ("mixtral-8x7b", "chameleon-34b")
AGREE_TOL = 1e-5
AGREE_LAYERS = 4
AGREE_B, AGREE_S, AGREE_STEPS, AGREE_CACHE = 2, 128, 32, 256
PREFILL_B, PREFILL_S = 2, 2048
DECODE_B, DECODE_CACHE = 8, 32768
TEACHER, GENERATED = 64, 32
# each card's peak over the dry run's prediction for the same cell
PEAK_RATIO = (0.8, 1.2)
SMOKE = {"agree_s": 16, "agree_steps": 8, "agree_cache": 32,
         "prefill_s": 64, "decode_cache": 128, "teacher": 8, "generated": 4}


def layouts(world: int):
    """(tag, mesh shape, the dry run's variant) of the two placements."""
    return (("base", (world, 1), "base"), ("opt", (world // 2, 2), "opt"))


def start_pos(cache: int, steps: int) -> int:
    """The first decode position: the ``steps`` steps straddle the cache's
    middle, so a cache split in two over ``model`` (``shard_cache_seq``)
    holds tokens on both ranks and each rank writes its own slots."""
    return cache // 2 - steps // 2


def start_predictions(args) -> dict:
    """The dry run's prediction of every full-size cell, each in a child
    process of its own on the host's CPU (a fake world of the mesh's
    size), started now: {(arch, tag, kind): the process}."""
    procs = {}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for arch in args.archs:
        for tag, shape, variant in layouts(args.world):
            for kind, batch, seq in (("prefill", PREFILL_B, args.prefill_s),
                                     ("decode", DECODE_B, args.decode_cache)):
                spec = {"arch": arch, "kind": kind, "batch": batch,
                        "seq": seq, "mesh": list(shape), "variant": variant,
                        "smoke": args.smoke,
                        "overrides": {"bf16_weight_gather": True}}
                procs[(arch, tag, kind)] = subprocess.Popen(
                    [sys.executable, "-W", "ignore", "-m",
                     "repro_torch.launch.dryrun", "--predict",
                     json.dumps(spec)], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True, env=env)
    return procs


def finish_predictions(procs) -> dict:
    """{(arch, tag, kind): the record} of ``start_predictions``."""
    out = {}
    for key, p in procs.items():
        try:
            text = p.communicate(timeout=WALL_S)[0]
            out[key] = json.loads(text.strip().splitlines()[-1])
        except (ValueError, IndexError, subprocess.TimeoutExpired) as e:
            p.kill()
            out[key] = {"ok": False, "error": repr(e)}
    return out


def run_rank(rank: int, args) -> None:
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.synthetic import zipf_tokens
    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as SP
    from repro_torch.models import init_decode_state, init_params
    from repro_torch.models.convert import placement
    from repro_torch.models.model import (decode_leaves, forward,
                                          init_params_placed)
    from repro_torch.models.steps import make_serve_step

    on_card = args.device == "cuda"
    if on_card:
        import chip_smoke as cs
        cs.set_allocator(torch, ALLOC_CONF)
        torch.cuda.set_device(rank)
    dev = torch.device(f"cuda:{rank}" if on_card else "cpu")
    dist.init_process_group(
        "nccl" if on_card else "gloo",
        init_method=f"tcp://localhost:{args.port}", rank=rank,
        world_size=args.world, device_id=dev if on_card else None,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    get = get_smoke_config if args.smoke else get_config
    out_f = open(os.path.join(ROOT, "chiprun_out", "serve_cards.jsonl"),
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
        got = [None] * args.world
        dist.all_gather_object(got, gib)
        return got

    def cell(arch, shape, variant, kind, batch, seq, base):
        """The dry run's cell on this mesh: (config, policy)."""
        mesh = init_device_mesh(dev.type, shape,
                                mesh_dim_names=("data", "model"))
        c = dryrun.cell_config(arch, SP.ShapeCell(kind, seq, batch, kind),
                               mesh, variant, cfg=base)
        return mesh, c[0], c[1]

    def rows_of(policy, mesh, n):
        """This rank's rows of a batch of n (all where it does not
        split)."""
        from repro_torch.launch.train import _batch_rows
        return _batch_rows(mesh, policy, n)

    def tokens(seed, shape, vocab):
        return torch.as_tensor(zipf_tokens(np.random.RandomState(seed),
                                           shape, vocab), device=dev)

    def replicated_equal(state, pl):
        """Whether every decode-state leaf the policy replicates over
        ``model`` is equal on every ``model`` rank."""
        if pl.sizes.get("model", 1) == 1:
            return True
        ok = True
        for key, *_, t in decode_leaves(state, state_cfg[0]):
            if "model" in str(state_specs[0].get(key, ())):
                continue
            got = [torch.empty_like(t) for _ in range(pl.sizes["model"])]
            dist.all_gather(got, t.contiguous(), group=pl.group("model"))
            ok &= all(torch.equal(g, got[0]) for g in got)
        return ok

    def live_slots(state, pl):
        """Per ``model`` rank, the slots of its block of the first split KV
        cache that hold a token (None where no cache is split)."""
        j = next((j for j, n in enumerate(state.seq_shards or ())
                  if n > 1), None)
        if j is None:
            return None
        k = state.block_states[j].k             # (B, S_local, nkv, dh)
        n = int(k.flatten(2).ne(0).any(-1).any(0).sum())
        got = [None] * pl.sizes["model"]
        dist.all_gather_object(got, n, group=pl.group("model"))
        return got

    state_cfg, state_specs = [None], [None]

    # -------------------------------------------------------------- agree
    if "agree" in args.parts:
        for arch in args.archs:
            base = get(arch).with_overrides(
                dtype="float32",
                n_layers=(len(get(arch).block_pattern) * 2 if args.smoke
                          else AGREE_LAYERS))
            s = args.agree_s
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            whole = init_params(base, generator=gen, device=dev)
            prompt = tokens(0, (AGREE_B, s), base.vocab_size)
            steps = tokens(1, (AGREE_B, args.agree_steps), base.vocab_size)
            res = {"part": "agree", "arch": arch, "n_layers": base.n_layers,
                   "dtype": "float32", "prefill": [AGREE_B, s],
                   "decode_steps": args.agree_steps,
                   "cache": args.agree_cache}
            for tag, shape, variant in layouts(args.world):
                mesh, cfg, policy = cell(arch, shape, variant, "decode",
                                         AGREE_B, args.agree_cache, base)
                gen = torch.Generator(device=dev)
                gen.manual_seed(0)
                placed = init_params_placed(
                    cfg, generator=gen, device=dev,
                    placement_of=lambda m: placement(m, policy))
                pl = placed.placement
                rows = rows_of(policy, mesh, AGREE_B)
                with torch.no_grad():
                    want = forward(whole, {"tokens": prompt}, cfg)[0]
                    got = forward(placed, {"tokens": prompt[rows]}, cfg)[0]
                scale = float(want.abs().max())
                pre_err = float((got - want[rows]).abs().max()) / scale
                pre_arg = bool(torch.equal(got.argmax(-1),
                                           want[rows].argmax(-1)))
                serve = make_serve_step(cfg)
                from repro_torch.models.model import decode_step
                first = start_pos(args.agree_cache, args.agree_steps)
                st_w = init_decode_state(cfg, AGREE_B, args.agree_cache,
                                         device=dev)
                st_w = st_w._replace(pos=torch.full_like(st_w.pos, first))
                st_p = init_decode_state(cfg, AGREE_B, args.agree_cache,
                                         device=dev, placement=pl)
                st_p = st_p._replace(pos=torch.full_like(st_p.pos, first))
                state_cfg[0] = cfg
                from repro_torch.models.model import decode_state_specs
                state_specs[0] = decode_state_specs(
                    init_decode_state(cfg, AGREE_B, args.agree_cache,
                                      device="meta"), cfg, policy)
                worst, arg_ok, repl_ok = 0.0, True, True
                for t in range(args.agree_steps):
                    lw, st_w = decode_step(whole, st_w, steps[:, t:t + 1],
                                           cfg)
                    lp, st_p = decode_step(placed, st_p,
                                           steps[rows, t:t + 1], cfg)
                    sc = float(lw.abs().max())
                    worst = max(worst, float((lp - lw[rows]).abs().max())
                                / sc)
                    arg_ok &= bool(torch.equal(lp.argmax(-1),
                                               lw[rows].argmax(-1)))
                    repl_ok &= replicated_equal(st_p, pl)
                nxt, _ = serve(placed, st_p, steps[rows, -1:])
                live = live_slots(st_p, pl)
                res[tag] = {"mesh": list(shape), "variant": variant,
                            "shard_cache_seq": policy.shard_cache_seq,
                            "seq_shards": max(st_p.seq_shards),
                            "first_pos": first,
                            "live_slots_by_model_rank": live,
                            "prefill_rel_err": pre_err,
                            "prefill_argmax_equal": pre_arg,
                            "decode_rel_err": worst,
                            "decode_argmax_equal": arg_ok,
                            "replicated_leaves_equal": repl_ok,
                            "serve_ids": nxt[:, 0].tolist()}
                check(pre_err <= AGREE_TOL and pre_arg and worst <= AGREE_TOL
                      and arg_ok and repl_ok,
                      f"agree {arch} {tag}: {res[tag]}")
                check(live is None or all(n > 0 for n in live),
                      f"agree {arch} {tag}: a model rank's cache block "
                      f"holds no token: {live}")
                del placed, st_p, st_w
            log(res)
            del whole
            if on_card:
                torch.cuda.empty_cache()

    # --------------------------------------------------------------- full
    if "full" in args.parts:
        for arch in args.archs:
            base = get(arch).with_overrides(bf16_weight_gather=True)
            for tag, shape, variant in layouts(args.world):
                mesh, cfg, policy = cell(arch, shape, variant, "decode",
                                         DECODE_B, args.decode_cache, base)
                sync()
                peak_reset()
                t0 = time.perf_counter()
                gen = torch.Generator(device=dev)
                gen.manual_seed(0)
                model = init_params_placed(
                    cfg, generator=gen, device=dev,
                    placement_of=lambda m: placement(m, policy))
                pl = model.placement
                sync()
                res = {"part": "full", "arch": arch, "mesh": list(shape),
                       "variant": variant, "n_layers": cfg.n_layers,
                       "param_count": cfg.param_count(),
                       "init_s": time.perf_counter() - t0,
                       "peak_gib_init": peaks()}
                # prefill: the dry run's prefill cell at this batch
                _, pcfg, ppol = cell(arch, shape, variant, "prefill",
                                     PREFILL_B, args.prefill_s, base)
                rows = rows_of(ppol, mesh, PREFILL_B)
                prompt = tokens(2, (PREFILL_B, args.prefill_s),
                                cfg.vocab_size)[rows]
                sync()
                peak_reset()
                times = []
                for _ in range(2):
                    sync()
                    t0 = time.perf_counter()
                    with torch.no_grad():
                        logits = forward(model, {"tokens": prompt}, pcfg,
                                         last_only=True)[0]
                    sync()
                    times.append(time.perf_counter() - t0)
                check(bool(torch.isfinite(logits).all()),
                      f"full {arch} {tag}: prefill logits not finite")
                res["prefill_s"] = times
                res["prefill_tokens_per_s"] = (PREFILL_B * args.prefill_s
                                               / times[-1])
                res["peak_gib_prefill"] = peaks()
                del logits
                # decode
                rows = rows_of(policy, mesh, DECODE_B)
                sync()
                peak_reset()
                counts0 = dict(pl.counts)
                first = start_pos(args.decode_cache,
                                  args.teacher + args.generated)
                state = init_decode_state(cfg, DECODE_B, args.decode_cache,
                                          device=dev, placement=pl)
                state = state._replace(pos=torch.full_like(state.pos, first))
                serve = make_serve_step(cfg)
                forced = tokens(3, (DECODE_B, args.teacher),
                                cfg.vocab_size)[rows]
                step_s, ids = [], []
                tok = forced[:, :1]
                for t in range(args.teacher + args.generated):
                    if t < args.teacher:
                        tok = forced[:, t:t + 1]
                    sync()
                    t0 = time.perf_counter()
                    nxt, state = serve(model, state, tok)
                    sync()
                    step_s.append(time.perf_counter() - t0)
                    if t >= args.teacher - 1:
                        ids.append(nxt)
                    tok = nxt
                gen_ids = torch.cat(ids, dim=1)
                check(bool(((gen_ids >= 0) & (gen_ids < cfg.vocab_size))
                           .all()), f"full {arch} {tag}: ids out of range")
                check(bool((state.pos == first + args.teacher
                            + args.generated).all()),
                      f"full {arch} {tag}: pos {state.pos}")
                live = live_slots(state, pl)
                check(live is None or all(n > 0 for n in live),
                      f"full {arch} {tag}: a model rank's cache block "
                      f"holds no token: {live}")
                res.update({
                    "decode_batch": DECODE_B, "cache": args.decode_cache,
                    "seq_shards": max(state.seq_shards),
                    "first_pos": first, "live_slots_by_model_rank": live,
                    "decode_steps": len(step_s),
                    "decode_ms_per_step": statistics.median(step_s[1:])
                    * 1e3,
                    "decode_ms_all": [x * 1e3 for x in step_s],
                    "peak_gib_decode": peaks(),
                    "collectives_per_step_rank0": {
                        k: (v - counts0[k]) / len(step_s)
                        for k, v in pl.counts.items()},
                    "generated_first_row": gen_ids[0].tolist()})
                log(res)
                del model, state, gen_ids
                if on_card:
                    torch.cuda.empty_cache()

    sync()
    dist.destroy_process_group()
    if out_f:
        out_f.close()
    if failed:
        raise SystemExit(f"serve_cards: {len(failed)} checks failed")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--parts", default="agree,full")
    ap.add_argument("--archs", default=",".join(ARCHS),
                    help="a comma list of " + ", ".join(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs at small sizes (checks the "
                         "script)")
    args = ap.parse_args()
    bad = train_cards.check_world(args, "serve_cards")
    if bad:
        return bad
    sizes = dict(agree_s=AGREE_S, agree_steps=AGREE_STEPS,
                 agree_cache=AGREE_CACHE, prefill_s=PREFILL_S,
                 decode_cache=DECODE_CACHE, teacher=TEACHER,
                 generated=GENERATED)
    if args.smoke:
        sizes.update(SMOKE)
    vars(args).update(sizes)
    args.archs = args.archs.split(",")
    import chip_smoke as cs
    if args.device == "cuda":
        print(cs.card_line(), flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    jsonl = os.path.join(out_dir, "serve_cards.jsonl")
    start = os.path.getsize(jsonl) if os.path.exists(jsonl) else 0
    procs = start_predictions(args) if "full" in args.parts else {}
    code = train_cards.launch(run_rank, args, WALL_S, "serve_cards")
    preds = finish_predictions(procs)
    # each full-size cell's card peaks beside the dry run's
    with open(jsonl) as f:
        f.seek(start)
        runs = [json.loads(line) for line in f if line.strip()]
    far = []
    for r in runs:
        if r.get("part") != "full":
            continue
        tag = "base" if r["variant"] == "base" else "opt"
        row = {"peak_vs_dryrun": r["arch"], "mesh": r["mesh"],
               "variant": r["variant"]}
        for kind in ("prefill", "decode"):
            pred = preds.get((r["arch"], tag, kind), {})
            row[f"{kind}_card_gib"] = max(r[f"peak_gib_{kind}"])
            row[f"{kind}_dryrun_gib"] = pred.get("peak_gib")
            row[f"{kind}_dryrun_wall_s"] = pred.get("wall_s")
            if pred.get("ok") and args.device == "cuda":
                ratio = row[f"{kind}_card_gib"] / pred["peak_gib"]
                row[f"{kind}_ratio"] = ratio
                if not PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]:
                    far.append([r["arch"], r["variant"], kind, ratio])
        print(json.dumps(row), flush=True)
        with open(jsonl, "a") as f:
            f.write(json.dumps(row) + "\n")
    bad = [list(k) + [v.get("error", "")[-300:]] for k, v in preds.items()
           if not v.get("ok")]
    if bad:
        print(json.dumps({"dryrun_failed": bad}), flush=True)
    if far:
        print(json.dumps({"peak_ratio_outside": far,
                          "limits": PEAK_RATIO}), flush=True)
    return code or (1 if bad or far else 0)


if __name__ == "__main__":
    sys.exit(main())
