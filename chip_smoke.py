#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version on the card at the main paths' shapes, and
then drives four collections end to end through
``repro_torch.core.QuantixarEngine``:

  phase A  cosine, HNSW, no quantization, bulk builder, over a SIFT-like
           corpus at SIFT's published size (1M x 128): build, 10,000 queries
           in batches of 1,024 (k=10, ef=64, width 4) held to recall@10
           against an exact top-k, delta inserts, masked searches at ~50 %
           (HNSW) and ~5 % (flat route) selectivity;
  phase B  the same checks in l2 over a Fashion-MNIST-like corpus at its
           published size (60k x 784);
  phase C  phase A's corpus, queries and ground truth with PQ codes
           (m=16, k=256, the repo's database config): quantizer training,
           the build over the reconstructions, code-domain search with the
           exact rescore at ef 64 and 256 and without it at ef 64, delta
           rows, and the masked searches (the ~5 % one scans the codes);
  phase D  the same with BQ codes (256 bits).

Every phase must pass and every kernel of its path must have launched, or
the script exits non-zero.  Before the last line it prints the card's name
and power limit and one JSON line with each kernel's launches, error, time,
plain-version time and bound; the last line is the device JSON.  It needs a
CUDA device and the repository's ``src/`` beside it, and fails without
either.
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
# population count: 16 results per clock per SM for compute capability 9.0
# (CUDA C++ Programming Guide, throughput of native arithmetic
# instructions), x 132 SMs x the H100 SXM's 1.98 GHz boost clock
POPC_PER_S = 16 * 132 * 1.98e9

# kernel-vs-plain tolerance: rtol as the JAX package's own kernel tests
# (tests/test_kernels.py, pair/beam gather); atol scaled by |a|*|b| of the
# two rows, because SIFT-scale squared L2 reaches ~1e5 and the CUDA kernels
# sum in another order than the plain versions
RTOL = 2e-4
ATOL_PER_NORM = 1e-5
# the ADC kernels add the same m LUT floats in the same order (i = 0..m-1)
# as their plain versions, so they agree to rounding: rtol 1e-6 (the JAX
# package's tests allow 1e-5).  Hamming is integer arithmetic: error 0.
ADC_RTOL = 1e-6

N_SIFT = 1_000_000       # SIFT-128's published size (phases A, C, D)
N_FMNIST = 60_000        # Fashion-MNIST-784's published size (phase B)
K = 10
EF = 64
WIDTH = 4
QUERY_BATCH = 1024
# the repo's database config (src/repro/configs/quantixar_db.py): PQ m=16,
# k=256 and BQ 256 bits over the 128-wide corpus
PQ_M, PQ_K, BQ_BITS = 16, 256, 256
FLAT_CHUNK = 65536       # the flat route's corpus chunk (core/engine.py)
# recall@10 floors by phase and ef, each a margin under the recall this
# script measured on an H100 (PERF.md): at ef=64 to catch a regression of
# the search itself, and at the ef where the phase first passes 0.80 (A,
# B) or at ef=256 (C, D, with the exact rescore).  The JAX package's own
# bulk builder stays under 0.80 at ef=64 at these sizes (PERF.md,
# scripts/recall_witness.py), so 0.80 is held at a larger ef.
RECALL_FLOORS = {"A": {64: 0.60, 256: 0.82},
                 "B": {64: 0.35, 512: 0.835},
                 "C": {64: 0.30, 256: 0.405},
                 "D": {64: 0.22, 256: 0.295}}
# the quantized phases' first pass alone (rescore off) at ef=64
FIRST_PASS_FLOORS = {"C": 0.18, "D": 0.12}
QUANT = {"A": "none", "B": "none", "C": "pq", "D": "bq"}
# the kernels each phase's path runs; each must launch in its phase
PHASE_KERNELS = {
    "A": ("beam_gather", "pair_gather"),
    "B": ("beam_gather", "pair_gather"),
    "C": ("beam_gather", "pair_gather", "beam_gather_adc", "pq_adc"),
    "D": ("beam_gather", "pair_gather", "beam_gather_hamming", "hamming")}


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


def bound(nbytes: float, ops: float, rate: float = FP32_FLOP_PER_S):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over their peak rate."""
    tb, tf = nbytes / HBM_BYTES_PER_S, ops / rate
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


def quant_kernel_checks(torch, codes, lut, words, q_words, log):
    """The PQ and BQ kernels against their plain versions on the corpus's
    real codes: ``codes`` (N, m) uint8 PQ codes with ``lut`` (Q, m, k) the
    queries' LUTs, ``words`` (N, W) BQ words with ``q_words`` (Q, W).

    library_ms, timed where one PyTorch call computes the same function:
    ``pq_adc`` is ``embedding_bag(codes + i * k, lut.T, mode="sum")`` over
    the flattened LUTs, and ``hamming`` is ``cdist(p=0)`` (the count of
    differing coordinates) over the unpacked bits; the index offsets, the
    transposed LUTs and the unpacked bits are made outside the timed call.
    The two gathers have none: the gather of code rows by ids is part of
    their function, and no one call both gathers and LUT-sums or counts.
    """
    import torch.nn.functional as F
    from repro_torch.core.bq import unpack_bits
    from repro_torch.kernels import ref
    from repro_torch.kernels.beam_gather_adc import beam_gather_adc
    from repro_torch.kernels.beam_gather_hamming import beam_gather_hamming
    from repro_torch.kernels.hamming import hamming
    from repro_torch.kernels.pq_adc import pq_adc

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    n, m = codes.shape
    nq, _, k = lut.shape
    w = words.shape[1]
    rows = []

    def row(name, err, fn, plain, b, library=None, **shape):
        lib_ms = time_ms(torch, library) if library else None
        rows.append({"name": name, **shape, "max_abs_err": err,
                     "ms": time_ms(torch, fn), "plain_ms": time_ms(torch, plain),
                     "bound_ms": b[0], "bound_us": b[0] * 1e3,
                     "bound_by": b[1], "library_ms": lib_ms})
        log(rows[-1])

    for length in (1, 128, 256):
        ids = torch.randint(0, n, (nq, length), generator=gen, device="cuda",
                            dtype=torch.int32)
        uniq = int(torch.unique(ids).numel())
        got = beam_gather_adc(lut, ids, codes)
        want = ref.beam_gather_adc_ref(lut, ids, codes)
        torch.cuda.synchronize()
        err = (got - want).abs()
        check(bool((err <= ADC_RTOL * want.abs()).all()),
              f"beam_gather_adc L={length}: max err {float(err.max())}")
        # bytes: unique code rows, the LUT entries this run's codes pick
        # (the unique 32-byte sectors, 8 floats each, of the (Q, m, k) LUTs
        # that they fall in: at L=1 a few percent, at L=128 nearly all),
        # ids, output; m adds an output
        picked = codes[ids.long()].long()                 # (Q, L, m)
        entry = ((torch.arange(nq, device="cuda")[:, None, None] * m
                  + torch.arange(m, device="cuda")) * k + picked)
        lut_bytes = int(torch.unique(entry // 8).numel()) * 32
        del picked, entry
        row("beam_gather_adc", float(err.max()),
            lambda: beam_gather_adc(lut, ids, codes),
            lambda: ref.beam_gather_adc_ref(lut, ids, codes),
            bound(uniq * m + lut_bytes + nq * length * 8, nq * length * m),
            Q=nq, L=length, m=m, k=k, N=n, lut_bytes=lut_bytes)
        got = beam_gather_hamming(q_words, ids, words)
        want = ref.beam_gather_hamming_ref(q_words, ids, words)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        check(err == 0, f"beam_gather_hamming L={length}: max err {err}")
        # bytes: unique word rows, query words, ids, output; W popcounts
        row("beam_gather_hamming", err,
            lambda: beam_gather_hamming(q_words, ids, words),
            lambda: ref.beam_gather_hamming_ref(q_words, ids, words),
            bound(uniq * w * 4 + nq * w * 4 + nq * length * 8,
                  nq * length * w, POPC_PER_S),
            Q=nq, L=length, W=w, N=n)

    # the flat route's shape (Q=1024 against one corpus chunk) and a small
    # batch against the whole corpus
    for q_n, rows_n in ((nq, FLAT_CHUNK), (64, n)):
        lut_q, cw = lut[:q_n], codes[:rows_n]
        got = pq_adc(lut_q, cw)
        want = ref.pq_adc_ref(lut_q, cw)
        # the library call: row n's bag holds its m codes offset into the
        # flattened (m * k, Q) LUTs; it adds in its own order (rtol 1e-5)
        idx = cw.long() + torch.arange(m, device="cuda") * k
        lut_t = lut_q.reshape(q_n, m * k).T.contiguous()
        lib = F.embedding_bag(idx, lut_t, mode="sum").T
        torch.cuda.synchronize()
        err = (got - want).abs()
        check(bool((err <= ADC_RTOL * want.abs()).all()),
              f"pq_adc Q={q_n} N={rows_n}: max err {float(err.max())}")
        check(bool(((lib - want).abs() <= 1e-5 * want.abs()).all()),
              f"embedding_bag Q={q_n} N={rows_n} disagrees with pq_adc_ref")
        del got, want, lib
        row("pq_adc", float(err.max()), lambda: pq_adc(lut_q, cw),
            lambda: ref.pq_adc_ref(lut_q, cw),
            bound(rows_n * m + q_n * m * k * 4 + q_n * rows_n * 4,
                  q_n * rows_n * m),
            lambda: F.embedding_bag(idx, lut_t, mode="sum"),
            Q=q_n, N=rows_n, m=m, k=k)
        del idx, lut_t
        qw, xw = q_words[:q_n], words[:rows_n]
        got = hamming(qw, xw)
        want = ref.hamming_ref(qw, xw)
        # the library call: the count of differing coordinates of the
        # unpacked bits, exact in fp32 up to 2**24
        q_bits = unpack_bits(qw, w * 32).float()
        x_bits = unpack_bits(xw, w * 32).float()
        lib = torch.cdist(q_bits, x_bits, p=0)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        check(err == 0, f"hamming Q={q_n} N={rows_n}: max err {err}")
        check(torch.equal(lib.int(), want),
              f"cdist(p=0) Q={q_n} N={rows_n} disagrees with hamming_ref")
        del got, want, lib
        row("hamming", err, lambda: hamming(qw, xw),
            lambda: ref.hamming_ref(qw, xw),
            bound(rows_n * w * 4 + q_n * w * 4 + q_n * rows_n * 4,
                  q_n * rows_n * w, POPC_PER_S),
            lambda: torch.cdist(q_bits, x_bits, p=0),
            Q=q_n, N=rows_n, W=w)
        del q_bits, x_bits
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases A-D: four collections through the engine
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


def search_all(eng, queries, ef, counters, rescore=None):
    """All queries in batches of QUERY_BATCH; returns (ids, the launch
    counters after the first batch)."""
    import numpy as np

    out, first = [], None
    for lo in range(0, len(queries), QUERY_BATCH):
        out.append(eng.search(queries[lo: lo + QUERY_BATCH], K, ef=ef,
                              expansion_width=WIDTH, rescore=rescore)[1])
        if first is None:
            first = counters.read()
    return np.concatenate(out), first


def run_collection(torch, name, corpus, queries, gt, new_rows, metric,
                   counters, log):
    """One phase: build, search sweep against ``gt``, delta rows, masked
    searches; every kernel of the phase's path must have launched."""
    import numpy as np

    from repro_torch.core import (BQConfig, EngineConfig, PQConfig,
                                  QuantixarEngine, recall_at_k)

    quant = QUANT[name]
    res = {"phase": name, "n": int(len(corpus)), "dim": int(corpus.shape[1]),
           "metric": metric, "quantization": quant}
    cfg = EngineConfig(dim=corpus.shape[1], metric=metric, index="hnsw",
                       quantization=quant, pq=PQConfig(m=PQ_M, k=PQ_K),
                       bq=BQConfig(bits=BQ_BITS), builder="bulk")
    eng = QuantixarEngine(cfg)
    eng.add(corpus)

    marks = []

    def progress(phase, done, total):
        if done == total:
            if phase == "quantize":
                # the quantizer's training + encode peak, then the build's
                torch.cuda.synchronize()
                res["quantize_peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
                torch.cuda.reset_peak_memory_stats()
            marks.append((phase, time.perf_counter()))

    counters.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.build(progress=progress)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    res["build_s"] = t_end - t0
    res["build_peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    phases, prev = {}, t0
    for phase, t in marks:
        phases[phase] = phases.get(phase, 0.0) + (t - prev)
        prev = t
    phases["repair+pack"] = t_end - prev
    res["build_phase_s"] = phases
    res["build_launches"] = counters.read()
    res["build_info"] = {k: v for k, v in eng.stats().items()
                         if k.startswith("build") or k in (
                             "mean_deg0", "max_level", "compression")}
    log({"build": res})

    floors = RECALL_FLOORS[name]
    sweep = {}
    efs = (64, 256) if quant != "none" else \
        [e for e in (64, 128, 256, 512) if e <= max(floors)]
    runs = [(ef, None) for ef in efs]
    if quant != "none":
        runs.append((EF, False))             # the first pass alone
    for ef, rescore in runs:
        before = counters.read()
        t0 = time.perf_counter()
        ids, first = search_all(eng, queries, ef, counters, rescore)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(ids.shape == (len(queries), K) and (ids >= 0).all(),
              f"{name}: search at ef={ef} returned unfilled slots")
        key = ef if rescore is None else f"{ef}_first_pass"
        sweep[key] = {"qps": len(queries) / secs,
                      "recall_at_10": recall_at_k(ids, gt),
                      "launches_first_batch": {
                          k: v - before[k] for k, v in first.items()}}
        log({"search": {"phase": name, "ef": key, **sweep[key]}})
        floor = floors.get(ef) if rescore is None else FIRST_PASS_FLOORS[name]
        if floor is not None:
            check(sweep[key]["recall_at_10"] >= floor,
                  f"{name}: recall@10 {sweep[key]['recall_at_10']} at "
                  f"ef={key} under its floor {floor}")
    res["ef_sweep"] = sweep
    res["qps"] = sweep[EF]["qps"]
    res["recall_at_10"] = sweep[EF]["recall_at_10"]

    # delta rows: visible at once, each its own nearest neighbour
    n0 = len(corpus)
    eng.add(new_rows)
    check(eng.delta_rows == len(new_rows) and eng.seals == 0
          and eng.quantizer_trains == int(quant != "none"),
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
        mask_gt = exact_topk(torch, eng.vectors, q, metric, K, mask=mask)
        res[f"mask_{sel}_recall_at_10"] = recall_at_k(ids, mask_gt)
    if quant == "none":
        check(res["mask_0.05_recall_at_10"] >= 0.999,
              f"{name}: exact flat route recall {res['mask_0.05_recall_at_10']}")
    res["launches"] = counters.read()
    for kname in PHASE_KERNELS[name]:
        check(res["launches"][kname] > 0,
              f"{name}: kernel {kname} never launched")
    log({"phase_result": res})
    del eng
    torch.cuda.empty_cache()
    return res


class Counters:
    """The kernels' launch counters, read as deltas since the last reset."""

    def __init__(self):
        from repro_torch.kernels import (beam_gather, beam_gather_adc,
                                         beam_gather_hamming, bulk_prune,
                                         hamming, pq_adc)
        self.mods = {"beam_gather": beam_gather, "pair_gather": bulk_prune,
                     "beam_gather_adc": beam_gather_adc,
                     "beam_gather_hamming": beam_gather_hamming,
                     "pq_adc": pq_adc, "hamming": hamming}

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

        from repro_torch.core import bq as bq_mod
        from repro_torch.core import pq as pq_mod
        from repro_torch.core.hnsw_build import preprocess_vectors
        sift_raw = torch.as_tensor(sift, device="cuda")
        sift_cos = torch.as_tensor(preprocess_vectors(sift, "cosine"),
                                   device="cuda")
        fm_dev = torch.as_tensor(fm, device="cuda")
        # phases C and D's codes, from quantizers trained as their builds
        # train them (same configs, same seed)
        t0 = time.perf_counter()
        pq = pq_mod.ProductQuantizer(pq_mod.PQConfig(
            m=PQ_M, k=PQ_K, metric="cosine"))
        pq.train(sift_raw, seed=0)
        bq = bq_mod.BinaryQuantizer(bq_mod.BQConfig(bits=BQ_BITS))
        bq.train(sift_raw, seed=0)
        q_dev = torch.as_tensor(sift_q[:QUERY_BATCH], device="cuda")
        codes, lut = pq.encode(sift_raw), pq.lut(q_dev)
        words, q_words = bq.encode(sift_raw), bq.encode(q_dev)
        signs = bq_mod.signs(words, BQ_BITS)
        log({"quantizers_s": time.perf_counter() - t0})
        rows = kernel_checks(torch, [(128, sift_cos, ("dot",)),
                                     (128, sift_raw, ("l2",)),
                                     (784, fm_dev, ("l2", "dot")),
                                     (BQ_BITS, signs, ("dot",))], log)
        rows += quant_kernel_checks(torch, codes, lut, words, q_words, log)
        del sift_raw, sift_cos, fm_dev, pq, bq, codes, lut, words, q_words
        del signs, q_dev
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        gt_sift = exact_topk(torch, sift, sift_q, "cosine", K)
        gt_fm = exact_topk(torch, fm, fm_q, "l2", K)
        log({"ground_truth_s": time.perf_counter() - t0})

        counters = Counters()
        phase = {}
        for name, corpus, q, gt, new, metric in (
                ("A", sift, sift_q, gt_sift, sift_new, "cosine"),
                ("B", fm, fm_q, gt_fm, fm_new, "l2"),
                ("C", sift, sift_q, gt_sift, sift_new, "cosine"),
                ("D", sift, sift_q, gt_sift, sift_new, "cosine")):
            phase[name] = run_collection(torch, name, corpus, q, gt, new,
                                         metric, counters, log)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        log_f.close()

    def pick(name, **shape):
        return next(r for r in rows if r["name"] == name
                    and all(r.get(k) == v for k, v in shape.items()))

    # the line reports each kernel at its main path's dominant shape:
    # search's (Q=1024, L=width*M0=128) gathers (cosine for beam_gather),
    # the coarse prune's (B=4096, C=60) pair matrices, and the flat route's
    # Q=1024 against one 65,536-row chunk; the full sweep is in the log.
    # launches: the count in the phase whose path the kernel serves first
    # (A for the unquantized kernels, C for PQ, D for BQ), and per phase.
    # library_ms: embedding_bag for pq_adc and cdist(p=0) for hamming
    # (quant_kernel_checks); null for the four gathers, since no single
    # PyTorch call fuses a row gather with its distance, pair matrix, LUT
    # sum or bit count.
    main_rows = {
        "beam_gather": (pick("beam_gather", mode="dot", D=128, L=128), "A",
                        "beam_gather.py:98"),
        "pair_gather": (pick("pair_gather", mode="dot", D=128, C=60), "A",
                        "bulk_prune.py:47"),
        "beam_gather_adc": (pick("beam_gather_adc", L=128), "C",
                            "beam_gather.py:148"),
        "beam_gather_hamming": (pick("beam_gather_hamming", L=128), "D",
                                "beam_gather.py:185"),
        "pq_adc": (pick("pq_adc", N=FLAT_CHUNK), "C", "pq_adc.py:59"),
        "hamming": (pick("hamming", N=FLAT_CHUNK), "D", "hamming.py:33")}
    kernels = []
    for name, (r, home, tpu) in main_rows.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": phase[home]["launches"][name],
            "launches_by_phase": {p: phase[p]["launches"][name]
                                  for p in phase},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            "at": {k: r[k] for k in ("mode", "Q", "L", "B", "C", "D", "N",
                                     "m", "k", "W") if k in r}})
    summary = {
        "seconds": time.perf_counter() - t_start,
        **{p["phase"]: {k: p.get(k) for k in (
            "build_s", "qps", "recall_at_10", "ef_sweep",
            "mask_0.5_recall_at_10", "mask_0.05_recall_at_10",
            "quantize_peak_gb", "build_peak_gb")}
           for p in phase.values()}}
    print(json.dumps({"summary": summary}, default=float))
    print(card)
    print(json.dumps({"kernels": kernels}, default=float))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
