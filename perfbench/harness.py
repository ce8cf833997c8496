"""One run of one cell: set-up, warm-up, the measured window, the reference,
the comparison and the result line.

Set-up makes the inputs on the device from the seed (`datagen`), hands them
to the configuration's system driver, which builds the program's index, and
warms up the cell's own shapes with the schedule's first batches.  The
window is a closed loop of one client (`traffic.Schedule`) for ``seconds``:
each batch is timed from its call until its ids are on the host; with
``trace`` the window runs under ``torch.profiler``.  Once it has closed the
peak memory is read, the program's state freed, and the reference
(``reference/<name>.py``) works the inputs out again from the seed to judge
every answer (`verdict`).  Metrics come from one reader each
(``metrics/<name>.py``).  Every cell runs on one chip, in this process.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch

from . import datagen, devtrace, verdict
from .manifest import Manifest
from .manifest import system as load_system
from .traffic import Mix, Schedule

#: batches of the schedule run before the window (first use, builds)
WARMUP_BATCHES = 3
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: torch's CPU threads from the warm-up on: the window's load is one host
#: thread driving the card, with no pool of CPU threads beside it
WINDOW_THREADS = 1


class RunError(RuntimeError):
    """The run cannot give a result."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def card_power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run(root: Path, opts: dict) -> dict:
    """One run of the cell ``opts["workload"]``: its result."""
    manifest = Manifest(root)
    cell = manifest.cell(opts["workload"])
    cfg = manifest.config(cell["config"])
    mix = Mix.from_spec(manifest.traffic(cell["traffic"]))
    on_card = opts.get("device", "cuda") == "cuda"
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.set_device(dev)
    return _run(manifest, cell, cfg, mix, int(opts["seed"]), dev, opts)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run(manifest, cell, cfg, mix, seed, dev, opts):
    t_start = opts["t_start"]
    # --- set-up: the inputs, the system, the warm-up
    marks = [("start", t_start)]
    corpus = datagen.corpus(cfg, seed, dev)
    pool = datagen.query_pool(cfg, seed, dev)
    schedule = Schedule(mix, pool.shape[0], seed)
    pool_host = pool[schedule.order.to(dev)].cpu().numpy()
    _sync(dev)
    marks.append(("inputs", time.perf_counter()))
    ctx = SimpleNamespace(config=cfg, mix=mix, seed=seed, device=dev,
                          corpus=corpus)
    system = load_system(opts.get("system") or cfg["system"]).build(ctx)
    if opts.get("fault"):
        mod, fn = opts["fault"].split(":")
        system = getattr(importlib.import_module(mod), fn)(system, ctx)
    del ctx, corpus, pool
    _sync(dev)
    marks.append(("system", time.perf_counter()))
    B = mix.batch

    def batch(j):
        s = schedule.start(j)
        return pool_host[s: s + B]

    threads = torch.get_num_threads()
    torch.set_num_threads(WINDOW_THREADS)
    for j in range(WARMUP_BATCHES):
        system.search(batch(j))
    _sync(dev)
    # the set-up's host objects (the index's) leave the collector, so that
    # no collection in the window walks them again
    gc.collect()
    gc.freeze()
    marks.append(("warmup", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    print("setup: " + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b)
        in zip(marks, marks[1:])), file=sys.stderr, flush=True)

    # --- the window
    trace = bool(opts.get("trace"))
    c0 = system.counters()
    records, ans_i, ans_d = [], [], []
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    ann = (lambda name: torch.profiler.record_function(name)) if trace \
        else (lambda name: contextlib.nullcontext())
    seconds = float(opts["seconds"])
    with ann(devtrace.WINDOW):
        t_w0 = time.perf_counter()
        j = WARMUP_BATCHES
        while True:
            q = batch(j)
            with ann(devtrace.BATCH):
                t0 = time.perf_counter()
                d, ids = system.search(q)
                t1 = time.perf_counter()
            records.append((j, t0, t1))
            ans_i.append(ids)
            ans_d.append(d)
            j += 1
            if t1 - t_w0 >= seconds:
                break
    _sync(dev)
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        from torch.autograd import DeviceType
        summary = devtrace.summarize(prof.profiler.kineto_results.events(),
                                     DeviceType.CUDA, DeviceType.CPU)
        del prof
    c1 = system.counters()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    system.close()
    del system
    gc.unfreeze()
    gc.collect()
    torch.set_num_threads(threads)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # --- the reference and the comparison
    window_s = records[-1][2] - t_w0
    judged = judge(cfg, mix, schedule, records, ans_i, ans_d, seed, dev)
    run = SimpleNamespace(
        cell=cell, config=cfg, mix=mix, setup_s=setup_s, window_s=window_s,
        latencies_s=[t1 - t0 for _, t0, t1 in records],
        batches=len(records), queries=len(records) * B,
        hits=judged["cmp"]["hits"], compared=judged["cmp"]["rows"],
        counters={key: c1[key] - c0.get(key, 0) for key in c1},
        trace=summary, n_total=int(cfg["rows"]))
    metrics = {}
    for m in manifest.metrics_of(cell["name"], trace):
        value = manifest.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device["card"] = card_power_limit()
    result = {"correct": verdict.passed(judged["checks"]),
              "attempted": run.queries, "failed": judged["cmp"]["bad"],
              "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        result["breakdown"] = {key: summary[key]
                               for key in ("device_ops", "idle_gaps")}
    result["checks"] = judged["checks"]
    return result


def judge(cfg, mix, schedule, records, ans_i, ans_d, seed, dev) -> dict:
    """Every answer of the window against the reference."""
    ref = importlib.import_module(f"perfbench.reference.{cfg['reference']}")
    distance = cfg["distance"]
    k = mix.k
    corpus = datagen.corpus(cfg, seed, dev)
    pool = datagen.query_pool(cfg, seed, dev)
    ids = torch.from_numpy(np.concatenate(ans_i)).to(dev, torch.int64)
    d = torch.from_numpy(np.concatenate(ans_d)).to(dev, torch.float32)
    pos = torch.cat([schedule.positions(j) for j, _, _ in records]).to(dev)
    # the exact answers, once for each distinct query of the pool
    uniq, inverse = torch.unique(pos, return_inverse=True)
    _, gt_i = ref.exact_topk(pool[uniq], corpus, k, distance)

    def pair64(q, i):
        x = corpus[i]
        qx = q[:, None, :].expand_as(x)
        return (ref.pair_distance64(distance, qx, x),
                ref.pair_scale64(distance, qx, x))

    cmp = verdict.compare(pool[pos], ids, d, pair64, corpus.shape[0],
                          gt_i[inverse])
    return {"cmp": cmp, "checks": verdict.checks(cmp, cfg, k)}


def print_result(result: dict) -> int:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output.  Refuses (non-zero, no
    result) where a forbidden module is loaded."""
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}",
              file=sys.stderr, flush=True)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def check_chips(chips: int) -> Optional[str]:
    """Why the run cannot start on this machine, or None."""
    if not torch.cuda.is_available():
        return "CUDA is not available"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards, this machine has "
                f"{torch.cuda.device_count()}")
    return None


def cli(root: Path, argv: List[str], t_start: float,
        system: Optional[str] = None) -> int:
    """``--workload --seed --seconds --trace`` -> one run on this machine's
    cards, its result printed; ``system`` puts another driver in the
    program's place (the control)."""
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opts = dict(vars(ap.parse_args(argv)), t_start=t_start)
    if system is not None:
        opts.update(system=system, trace=0)
    cuda_env(root)
    why = check_chips(int(Manifest(root).cell(opts["workload"])["chips"]))
    if why is not None:
        print(f"perfbench: {why}: no run", file=sys.stderr)
        return 2
    return print_result(run(root, opts))


def cuda_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    import os
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
