#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version on the card at the main path's shapes, and
then drives the default collection end to end through
``repro_torch.core.QuantixarEngine``:

  phase A  cosine, HNSW, no quantization, bulk builder, over a SIFT-like
           corpus at SIFT's published size (1M x 128): build, 10,000 queries
           in batches of 1,024 (k=10, ef=64, width 4) held to recall@10
           against an exact top-k, delta inserts, masked searches at ~50 %
           (HNSW) and ~5 % (flat route) selectivity;
  phase B  the same checks in l2 over a Fashion-MNIST-like corpus at its
           published size (60k x 784).

Every phase must pass and both kernels must have launched on the main path,
or the script exits non-zero.  Before the last line it prints the card's
name and power limit and one JSON line with each kernel's launches, error,
time, plain-version time and bound; the last line is the device JSON.  It
needs a CUDA device and the repository's ``src/`` beside it, and fails
without either.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# every result line also goes here (git-ignored), for runs whose console
# output is cut short
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# kernel-vs-plain tolerance: rtol as the JAX package's own kernel tests
# (tests/test_kernels.py, pair/beam gather); atol scaled by |a|*|b| of the
# two rows, because SIFT-scale squared L2 reaches ~1e5 and the CUDA kernels
# sum in another order than the plain versions
RTOL = 2e-4
ATOL_PER_NORM = 1e-5

N_SIFT = 1_000_000       # SIFT-128's published size (phase A)
N_FMNIST = 60_000        # Fashion-MNIST-784's published size (phase B)
K = 10
EF = 64
WIDTH = 4
QUERY_BATCH = 1024
# recall@10 floors by phase and ef, each a margin under the recall this
# script measured on an H100 (PERF.md): at ef=64 to catch a regression of
# the search itself, and at the ef where the phase first passes 0.80.  The
# JAX package's own bulk builder stays under 0.80 at ef=64 at these sizes
# (PERF.md, scripts/recall_witness.py), so 0.80 is held at a larger ef.
RECALL_FLOORS = {"A": {64: 0.60, 256: 0.82},
                 "B": {64: 0.35, 512: 0.835}}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def time_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version on the card
# ---------------------------------------------------------------------------

def kernel_checks(torch, corpora, log):
    from repro_torch.kernels import beam_gather as bg
    from repro_torch.kernels import bulk_prune as pg
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for d, corpus, modes in corpora:
        n = corpus.shape[0]
        norms = corpus.norm(dim=1)
        for mode in modes:
            plain = ref.beam_gather_l2_ref if mode == "l2" \
                else ref.beam_gather_dot_ref
            for length in (1, 128, 256):
                nq = QUERY_BATCH
                ids = torch.randint(0, n, (nq, length), generator=gen,
                                    device="cuda", dtype=torch.int32)
                q = corpus[torch.randint(0, n, (nq,), generator=gen,
                                         device="cuda")]
                q = q + 0.01 * torch.randn(q.shape, generator=gen,
                                           device="cuda")
                got = bg.beam_gather(q, ids, corpus, mode=mode)
                want = plain(q, ids, corpus)
                torch.cuda.synchronize()
                err = (got - want).abs()
                tol = RTOL * want.abs() \
                    + ATOL_PER_NORM * q.norm(dim=1)[:, None] * norms[ids.long()]
                check(bool((err <= tol).all()),
                      f"beam_gather {mode} D={d} L={length}: max err "
                      f"{float(err.max())} over tolerance")
                uniq = int(torch.unique(ids).numel())
                nbytes = uniq * d * 4 + nq * d * 4 + nq * length * 8
                flops = nq * length * d * (3 if mode == "l2" else 2)
                b_ms, b_by = bound(nbytes, flops)
                rows.append({
                    "name": "beam_gather", "mode": mode, "Q": nq, "L": length,
                    "D": d, "N": n, "max_abs_err": float(err.max()),
                    "ms": time_ms(torch, lambda: bg.beam_gather(
                        q, ids, corpus, mode=mode)),
                    "plain_ms": time_ms(torch, lambda: plain(q, ids, corpus)),
                    "bound_ms": b_ms, "bound_us": b_ms * 1e3,
                    "bound_by": b_by})
                log(rows[-1])
            plain = ref.pair_gather_l2_ref if mode == "l2" \
                else ref.pair_gather_dot_ref
            # main-path shapes: the coarse prune (4096-node chunks of 52
            # kNN + 8 random candidates) and the stitch re-prune (1024-node
            # batches of 48 beam hits + the 32-slot row)
            for b, c in ((4096, 60), (1024, 80)):
                ids = torch.randint(0, n, (b, c), generator=gen,
                                    device="cuda", dtype=torch.int32)
                got = pg.pair_gather(ids, corpus, mode=mode)
                want = plain(ids, corpus)
                torch.cuda.synchronize()
                err = (got - want).abs()
                nr = norms[ids.long()]
                tol = RTOL * want.abs() \
                    + ATOL_PER_NORM * nr[:, :, None] * nr[:, None, :]
                check(bool((err <= tol).all()),
                      f"pair_gather {mode} D={d} C={c}: max err "
                      f"{float(err.max())} over tolerance")
                # the C x C output is symmetric: the function needs only its
                # C(C+1)/2 distinct dot products (the diagonal gives the l2
                # norms), plus for l2 a 3-op epilogue on each; the output
                # is written whole
                uniq = int(torch.unique(ids).numel())
                pairs = b * c * (c + 1) // 2
                nbytes = uniq * d * 4 + b * c * 4 + b * c * c * 4
                flops = pairs * d * 2 + (pairs * 3 if mode == "l2" else 0)
                b_ms, b_by = bound(nbytes, flops)
                rows.append({
                    "name": "pair_gather", "mode": mode, "B": b, "C": c,
                    "D": d, "N": n, "max_abs_err": float(err.max()),
                    "ms": time_ms(torch, lambda: pg.pair_gather(
                        ids, corpus, mode=mode)),
                    "plain_ms": time_ms(torch, lambda: plain(ids, corpus)),
                    "bound_ms": b_ms, "bound_us": b_ms * 1e3,
                    "bound_by": b_by})
                log(rows[-1])
    return rows


# ---------------------------------------------------------------------------
# phases A and B: the default collection through the engine
# ---------------------------------------------------------------------------

def exact_topk(torch, corpus, queries, metric, k, mask=None):
    """Exact top-k by plain torch.matmul on the card (the recall yardstick),
    optionally over the rows a mask keeps."""
    from repro_torch.core.distances import get_metric

    out = []
    pair = get_metric(metric)
    corpus_dev = torch.as_tensor(corpus, device="cuda")
    for lo in range(0, len(queries), QUERY_BATCH):
        q = torch.as_tensor(queries[lo: lo + QUERY_BATCH], device="cuda")
        d = pair(q, corpus_dev)
        if mask is not None:
            d = d.masked_fill(~torch.as_tensor(mask, device="cuda")[None],
                              float("inf"))
        out.append(torch.topk(d, k, largest=False, dim=1).indices.cpu())
    return torch.cat(out).numpy()


def search_all(eng, queries, ef, counters):
    """All queries in batches of QUERY_BATCH; returns (ids, the launch
    counters after the first batch)."""
    import numpy as np

    out, first = [], None
    for lo in range(0, len(queries), QUERY_BATCH):
        out.append(eng.search(queries[lo: lo + QUERY_BATCH], K, ef=ef,
                              expansion_width=WIDTH)[1])
        if first is None:
            first = counters.read()
    return np.concatenate(out), first


def run_collection(torch, name, corpus, queries, new_rows, metric, counters,
                   log):
    import numpy as np

    from repro_torch.core import EngineConfig, QuantixarEngine, recall_at_k

    res = {"phase": name, "n": int(len(corpus)), "dim": int(corpus.shape[1]),
           "metric": metric}
    cfg = EngineConfig(dim=corpus.shape[1], metric=metric, index="hnsw",
                       quantization="none", builder="bulk")
    eng = QuantixarEngine(cfg)
    eng.add(corpus)

    marks = []

    def progress(phase, done, total):
        if done == total:
            marks.append((phase, time.perf_counter()))

    counters.reset()
    t0 = time.perf_counter()
    eng.build(progress=progress)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    res["build_s"] = t_end - t0
    phases, prev = {}, t0
    for phase, t in marks:
        phases[phase] = phases.get(phase, 0.0) + (t - prev)
        prev = t
    phases["repair+pack"] = t_end - prev
    res["build_phase_s"] = phases
    res["build_launches"] = counters.read()
    res["build_info"] = {k: v for k, v in eng.stats().items()
                         if k.startswith("build") or k in ("mean_deg0",
                                                           "max_level")}
    log({"build": res})

    gt = exact_topk(torch, corpus, queries, metric, K)
    floors = RECALL_FLOORS[name]
    sweep = {}
    for ef in (e for e in (64, 128, 256, 512) if e <= max(floors)):
        before = counters.read()
        t0 = time.perf_counter()
        ids, first = search_all(eng, queries, ef, counters)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(ids.shape == (len(queries), K) and (ids >= 0).all(),
              f"{name}: search at ef={ef} returned unfilled slots")
        sweep[ef] = {"qps": len(queries) / secs,
                     "recall_at_10": recall_at_k(ids, gt),
                     "launches_first_batch": {
                         k: v - before[k] for k, v in first.items()}}
        log({"search": {"phase": name, "ef": ef, **sweep[ef]}})
        if ef in floors:
            check(sweep[ef]["recall_at_10"] >= floors[ef],
                  f"{name}: recall@10 {sweep[ef]['recall_at_10']} at ef={ef}"
                  f" under its floor {floors[ef]}")
    res["ef_sweep"] = sweep
    res["qps"] = sweep[EF]["qps"]
    res["recall_at_10"] = sweep[EF]["recall_at_10"]

    # delta rows: visible at once, each its own nearest neighbour
    n0 = len(corpus)
    eng.add(new_rows)
    check(eng.delta_rows == len(new_rows) and eng.seals == 0,
          f"{name}: new rows did not stay in the delta segment")
    hits = np.concatenate([eng.search(new_rows[lo: lo + QUERY_BATCH], K)[1]
                           for lo in range(0, len(new_rows), QUERY_BATCH)])
    res["delta_self_rank1"] = float(
        (hits[:, 0] == n0 + np.arange(len(new_rows))).mean())
    check(res["delta_self_rank1"] == 1.0,
          f"{name}: delta self-hit rate {res['delta_self_rank1']}")

    # masked searches: ~50 % (HNSW under a mask) and ~5 % (flat route)
    rng = np.random.RandomState(7)
    q = queries[:QUERY_BATCH]
    for sel in (0.5, 0.05):
        mask = rng.random_sample(len(eng)) < sel
        d, ids = eng.search(q, K, mask=mask)
        ok = ids >= 0
        check(bool(ok.all()), f"{name}: masked search ({sel}) unfilled")
        check(bool(mask[ids[ok]].all()),
              f"{name}: masked search ({sel}) returned a masked-out row")
        gt = exact_topk(torch, eng.vectors, q, metric, K, mask=mask)
        res[f"mask_{sel}_recall_at_10"] = recall_at_k(ids, gt)
    check(res["mask_0.05_recall_at_10"] >= 0.999,
          f"{name}: exact flat route recall {res['mask_0.05_recall_at_10']}")
    res["launches"] = counters.read()
    for kname, count in res["launches"].items():
        check(count > 0, f"{name}: kernel {kname} never launched")
    log({"phase_result": res})
    del eng
    torch.cuda.empty_cache()
    return res


class Counters:
    """The kernels' launch counters, read as deltas since the last reset."""

    def __init__(self):
        from repro_torch.kernels import beam_gather as bg
        from repro_torch.kernels import bulk_prune as pg
        self.mods = {"beam_gather": bg, "pair_gather": pg}

    def reset(self):
        for m in self.mods.values():
            m.launches = 0

    def read(self):
        return {k: m.launches for k, m in self.mods.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: nothing run", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    os.makedirs(OUT_DIR, exist_ok=True)
    log_path = os.path.join(OUT_DIR, "chip_smoke.jsonl")
    log_f = open(log_path, "w")

    def log(obj):
        line = json.dumps(obj, default=float)
        print(line, flush=True)
        log_f.write(line + "\n")
        log_f.flush()

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    try:
        from repro_torch.data.synthetic import fashion_mnist_like, sift_like
        from repro_torch.kernels import _build

        t0 = time.perf_counter()
        built = _build.build()
        log({"kernel_build_s": time.perf_counter() - t0,
             "per_kernel_s": {k: v[0] for k, v in built.items()}})
        for k, (_, text) in built.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {k}: {line.strip()}")

        t0 = time.perf_counter()
        sift = sift_like(N_SIFT, seed=0)
        sift_q = sift_like(10_000, seed=1)
        sift_new = sift_like(5_000, seed=2)
        fm = fashion_mnist_like(N_FMNIST, seed=0)
        fm_q = fashion_mnist_like(1_000, seed=1)
        fm_new = fashion_mnist_like(1_000, seed=2)
        log({"data_s": time.perf_counter() - t0})

        from repro_torch.core.hnsw_build import preprocess_vectors
        sift_raw = torch.as_tensor(sift, device="cuda")
        sift_cos = torch.as_tensor(preprocess_vectors(sift, "cosine"),
                                   device="cuda")
        fm_dev = torch.as_tensor(fm, device="cuda")
        rows = kernel_checks(torch, [(128, sift_cos, ("dot",)),
                                     (128, sift_raw, ("l2",)),
                                     (784, fm_dev, ("l2", "dot"))], log)
        del sift_raw, sift_cos, fm_dev
        torch.cuda.empty_cache()

        counters = Counters()
        phase_a = run_collection(torch, "A", sift, sift_q, sift_new,
                                 "cosine", counters, log)
        phase_b = run_collection(torch, "B", fm, fm_q, fm_new, "l2",
                                 counters, log)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        log_f.close()

    def pick(name, **shape):
        return next(r for r in rows if r["name"] == name
                    and all(r[k] == v for k, v in shape.items()))

    # the line reports each kernel at its main path's dominant shape:
    # search's (Q=1024, L=width*M0=128) cosine gathers, and the coarse
    # prune's (B=4096, C=60) pair matrices; the full sweep is in the log
    main_rows = {"beam_gather": pick("beam_gather", mode="dot", D=128, L=128),
                 "pair_gather": pick("pair_gather", mode="dot", D=128, C=60)}
    source = {"beam_gather": ("src/repro_torch/csrc/beam_gather.cu",
                              "src/repro/kernels/beam_gather.py:98"),
              "pair_gather": ("src/repro_torch/csrc/pair_gather.cu",
                              "src/repro/kernels/bulk_prune.py:47")}
    kernels = []
    for name, r in main_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source[name][0],
            "replaces": source[name][1],
            "launches": phase_a["launches"][name],
            "launches_phase_b": phase_b["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "at": {k: r[k] for k in ("mode", "Q", "L", "B", "C", "D", "N")
                   if k in r}})
    summary = {
        "seconds": time.perf_counter() - t_start,
        **{p["phase"]: {k: p[k] for k in (
            "build_s", "qps", "recall_at_10", "ef_sweep",
            "mask_0.5_recall_at_10")} for p in (phase_a, phase_b)}}
    print(json.dumps({"summary": summary}, default=float))
    print(card)
    print(json.dumps({"kernels": kernels}, default=float))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
