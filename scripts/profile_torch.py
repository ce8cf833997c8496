#!/usr/bin/env python3
"""Where the time of the port's collections goes, under torch.profiler.

Builds one of ``chip_smoke.py``'s SIFT-size phases over
``sift_like(1_000_000, seed=0)`` (cosine, HNSW, bulk builder; ``--phase``
A: no quantization, C: PQ m=16 k=256, D: BQ 256 bits) and searches its
10,000 queries in batches of 1,024 (k=10, ef=64, width 4; C and D with the
exact rescore), all under ``torch.profiler``.  For each build phase (cut at
the engine's and builder's ``progress`` marks: "quantize" is the quantizer's
training and the corpus's encoding), for the search, and for one batch
under a ~5 % mask (the flat route) it prints, as one JSON line each:

  wall_ms    host wall time of the span, profiler on;
  device_ms  summed duration of every device event (kernels, copies, sets)
             that starts in the span, and busy = device_ms / wall_ms (one
             stream, so the events do not overlap);
  <kernel>_ms  each of the port's CUDA kernels' share (beam_gather,
             beam_gather_lists and beam_gather_lists_topk: B1's gather
             entry and its list-major entries, the matrix one and the fused
             top-k one,
             pair_gather, beam_gather_adc, beam_gather_hamming (both of
             B4's entries), pq_adc, hamming, l2_distance, l2_topk: B5's
             matrix and fused entries), and <kernel>_launches its count;
  topk_ms    the share of PyTorch's top-k kernels (names holding "topk",
             the port's kernels aside: the scans' selections, and behind
             ``l2_topk`` the merge of its per-block candidates);
  host_ms    wall_ms - device_ms;
  top        the device events that take most of the span, by name.

In A, C and D a "search_steps" row reads the search's layer-0 steps from the
program's own spans (``repro_torch.tracing``, recorded under the profiler):
steps_per_batch (``hnsw.step`` spans a batch), fresh_share (the steps'
fresh slots over the slots their distance kernel is launched over),
active_share (the queries still searching over the batch's), host_ms_per_step
(a step less its sync) and wait_ms_per_batch (every wait span: the loops'
syncs and the engine's copies to the host).

``--phase G`` builds and searches phase G's IVF engine instead (cosine,
nlist 1,024, nprobe 32; the build spans are "kmeans" and "lists", the
last span empty): the search span gives B1's list-major entry's ms over
the probed lists (``beam_gather_lists_topk``, the fused top-k entry at k =
10; ``beam_gather_lists`` and the candidates' top-k, ``topk_ms``, in a
tree without it) against the coarse probe's (``l2_distance``: the matrix
route, k = nprobe past the fused entry's fast k) and the host's.  The
search span holds the process's first searches, right after the build
(each kernel's and torch operation's first use in the process), so G also
prints a "search_again" span: the same batches once more, warm, as
``chip_smoke.py``'s G profiles them.

``--phase H`` profiles phase H's sharded collection instead: the same
corpus by string id in an exact cosine collection at 4 shards x 2
replicas (every engine on the card) with a keyword and a numeric field,
behind ``QuantixarService`` and the HTTP server on 127.0.0.1, after a
warm-up: one embedded 1,024-query batch, the same batch through
``QuantixarClient``, and 512 single-vector queries from 32 client threads
(the collection's batcher coalesces them), each span with its wall,
device and busy share.

``--phase I`` profiles the distributed search (``repro_torch.distributed``)
at world 1 under quantixar-db's settings (k = 100, one 1,024-query batch;
PQ m 16 / k 256 and BQ 256 bits trained as phases C and D train them):
one span for each scan (flat cosine as -q.x on unit rows, flat l2, PQ,
BQ), and one for the same batch with one process playing the 2 row x 2
model shards of "dims" mode (B5's matrix entry, B6 or B7 on each half,
the halves added a row chunk at a time).

``--phase E`` profiles the public API instead: an exact (flat) cosine
collection of the same corpus through ``repro_torch.api.Database``, one
warm-up batch, then one 1,024-query batch (k=10), which scans the whole
corpus in one launch of B5's fused entry (``l2_topk``: distances and each
block's top-k, no (Q, N) matrix); its span gives that kernel's ms against
the candidates' merge (``topk_ms``) and against the host's.

``--phase F`` profiles the xLSTM serving path instead: xlstm-1.3b at full
width (random weights, ``torch.Generator`` seeded 0), one warm-up prefill of
8 x 256 tokens, then one prefill of 8 x 2,048 Zipf tokens through
``repro_torch.models.forward``.  Each mLSTM chunk of the chunkwise loop runs
in a span closed by a synchronize (one per chunk: 8 per mLSTM layer, 336 in
all, so the device events fall inside it and the wall time stretches a
little).  It prints the prefill's wall_ms, device_ms and busy, the
``slstm`` kernel's ms and launches, the mLSTM chunk loop's ms (every device
event inside the chunk spans) and the matrix products' ms (device kernels
named as cuBLAS / CUTLASS GEMMs: "gemm", "nvjet", "xmma", "cutlass"), in
all and inside the chunk loop, and the largest device items by name.

``--phase J`` profiles one full-size qwen2-1.5b prefill of 8 x 2,048 Zipf
tokens in bf16 (random weights, seeded 0, after a warm-up of 8 x 256): each
call of the attention core (the chunked online softmax at this length) runs
in a span closed by a synchronize; it prints wall_ms, device_ms, busy and
host_ms, the attention core's device ms (and of it the products'), the
other matrix products' ms (the projections, the MLP, the logits), the
elementwise rest (the attention core against
``F.scaled_dot_product_attention`` is ``chip_smoke.py``'s phase J
yardstick).  ``--phase K`` profiles one granite-moe-3b-a800m prefill of
2 x 2,048 tokens the same way, each MoE wave in a span and its experts'
products in one inside it: the MoE's device ms split into the experts'
products and the routing's dispatch / combine.  Both run at the configs'
own depth.  F, J and K serve: they run under ``torch.no_grad()``.

``--phase L`` profiles one train step (``repro_torch.models.make_train_step``:
loss, its gradient with each pattern unit recomputed, AdamW) of xlstm-1.3b
and then of qwen2-1.5b at full size, 8 x 2,048 tokens of the
``lm_batches`` stream (``--train-batch`` / ``--train-seq`` to cut them),
after a warm-up step.  Each unit's forward, each unit's recompute in the
backward, the logits and CE, the backward call and AdamW run in spans
opened and closed by a synchronize (the wall time stretches; the step's
unprofiled time is ``chip_smoke.py``'s L), and the device events are
assigned by start time:
``forward_ms`` and ``recompute_ms`` by the unit's block pattern,
``logits_ce_ms`` (forward), ``backward_ms`` by the unit whose recompute
came last before the event (autograd runs a unit's backward right after
recomputing it; before the first recompute the logits' and CE's backward,
``backward_logits_ce_ms``), ``adamw_ms``, ``b8_ms`` / ``b8t_ms`` (the
``slstm`` kernel's forward and B8ᵀ's backward, also inside the buckets
above) with their launches, ``other_ms`` (the device time outside every
bucket: gathering and zeroing the gradients, the embedding), and
``host_ms`` = wall_ms - device_ms.

Run on a card from the repository root:

    python3 scripts/profile_torch.py              # phase A, ~3 minutes
    python3 scripts/profile_torch.py --phase C    # PQ
    python3 scripts/profile_torch.py --phase E    # one exact API batch
    python3 scripts/profile_torch.py --phase F    # one xLSTM prefill
    python3 scripts/profile_torch.py --phase G    # IVF build and search
    python3 scripts/profile_torch.py --phase H    # sharded, over HTTP
    python3 scripts/profile_torch.py --phase I    # distributed search
    python3 scripts/profile_torch.py --phase J    # one qwen2-1.5b prefill
    python3 scripts/profile_torch.py --phase K    # one granite MoE prefill
    python3 scripts/profile_torch.py --phase L    # one train step a model
    python3 scripts/profile_torch.py --n 20000    # a quick look

``--device cpu`` runs the same path with host events only (no device
numbers), to check the script itself.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import functools
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

K, EF, WIDTH, QUERY_BATCH = 10, 64, 4, 1024
QUANT = {"A": "none", "C": "pq", "D": "bq", "E": "none", "G": "none"}
# phase G's IVF setting (chip_smoke.py's IVF_NLIST, IVF_NPROBE)
IVF_NLIST, IVF_NPROBE = 1024, 32
# each kernel's device functions, as the profiler names them (demangled), by
# parts no other kernel's name contains
KERNELS = {"beam_gather": ("beam_gather_f32_kernel",),
           "beam_gather_lists": ("beam_gather_lists_kernel",),
           "beam_gather_lists_topk": ("beam_gather_lists_topk_kernel",),
           "pair_gather": ("pair_gather_f32_kernel",),
           "beam_gather_adc": ("beam_gather_adc_kernel",),
           "beam_gather_hamming": ("beam_gather_hamming_kernel",),
           "pq_adc": ("pq_adc_",),
           "hamming": ("::hamming_kernel",),
           "l2_distance": ("l2_distance_kernel",),
           "l2_topk": ("l2_topk_kernel",),
           "slstm": ("slstm_",),
           "slstm_forward": ("slstm_sequence_kernel", "slstm_cluster_kernel"),
           "slstm_backward": ("slstm_backward_kernel",
                              "slstm_backward_cluster_kernel")}


def is_kernel(parts, name: str) -> bool:
    """Whether the device event ``name`` is one of the kernels ``parts``
    (a KERNELS value) names."""
    return any(p in name for p in parts)


# the device kernels of the matrix products (cuBLAS / cuBLASLt / CUTLASS)
GEMM_PARTS = ("gemm", "nvjet", "xmma", "cutlass")


def span_rows(prof, labels):
    """Assign the device events to the host spans by start time and print
    one JSON row per span; returns (device events, summed device ms)."""
    from torch.autograd import DeviceType

    # the raw events (ns): building the profiler's event tree over ~10^6
    # device events takes minutes.  A span is its host-side annotation; the
    # copy the profiler also puts on the device timeline is no device work.
    ranges, dev = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith("span::"):
            if e.device_type() == DeviceType.CPU:
                ranges.append((e.start_ns(), e.end_ns(),
                               labels.get(name[6:], name[6:])))
        elif e.device_type() == DeviceType.CUDA:
            dev.append((e.start_ns(), e.duration_ns(), name))
    ranges.sort()
    per_span = {name: collections.Counter() for _, _, name in ranges}
    n_span = {name: collections.Counter() for _, _, name in ranges}
    for start, dur, name in sorted(dev):
        for lo, hi, span in ranges:
            if lo <= start < hi:
                per_span[span][name] += dur
                n_span[span][name] += 1
                break
    total_dev = 0.0
    for lo, hi, name in ranges:
        c = per_span[name]
        wall_ms = (hi - lo) / 1e6
        dev_ms = sum(c.values()) / 1e6
        total_dev += dev_ms
        row = {"span": name, "wall_ms": wall_ms, "device_ms": dev_ms,
               "busy": dev_ms / wall_ms if wall_ms else None,
               "host_ms": wall_ms - dev_ms}
        for k, parts in KERNELS.items():
            row[f"{k}_ms"] = sum(v for n, v in c.items()
                                 if is_kernel(parts, n)) / 1e6
            row[f"{k}_launches"] = sum(v for n, v in n_span[name].items()
                                       if is_kernel(parts, n))
        row["topk_ms"] = sum(v for n, v in c.items()
                             if "topk" in n.lower() and not any(
                                 is_kernel(parts, n)
                                 for parts in KERNELS.values())) / 1e6
        row["top"] = [[n[:80], v / 1e6] for n, v in c.most_common(6)]
        print(json.dumps(row), flush=True)
    return dev, total_dev


def profile_exact(args, x, q) -> int:
    """Phase E: one 1,024-query batch of an exact collection through the
    public API, under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.api import Database, VectorField

    on_card = args.device != "cpu"
    db = Database(device=args.device)
    col = db.create_collection(name="exact", vector=VectorField(
        dim=x.shape[1], metric="cosine", index="flat"))
    for lo in range(0, len(x), 50_000):
        col.upsert([str(i) for i in range(lo, min(lo + 50_000, len(x)))],
                   x[lo: lo + 50_000])
    batch = q[:QUERY_BATCH]
    col.query(batch).top_k(K).run()           # warm-up: corpus to device
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        with record_function("span::exact_batch"):
            col.query(batch).top_k(K).run()
            if on_card:
                torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev, total_dev = span_rows(prof, {})
    print(json.dumps({"phase": "E", "wall_s_profiled": wall,
                      "device_events": len(dev), "device_ms": total_dev}),
          flush=True)
    db.close()
    if on_card and not dev:
        print("profile_torch: the profiler recorded no device events",
              file=sys.stderr)
        return 1
    return 0


def profile_cluster(args, x, q) -> int:
    """Phase H: a 4 x 2 sharded exact collection, embedded and over HTTP,
    under the profiler."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.api import (Database, KeywordField, NumericField,
                                 QuantixarClient, VectorField)
    from repro_torch.serving.http import QuantixarHTTPServer
    from repro_torch.serving.service import QuantixarService

    on_card = args.device != "cpu"
    db = Database(device=args.device)
    col = db.create_collection(
        name="sharded", vector=VectorField(dim=x.shape[1], metric="cosine",
                                           index="flat"),
        fields=(KeywordField("category"), NumericField("price")),
        shards=4, replicas=2)
    rng = np.random.RandomState(3)
    cats, prices = rng.randint(0, 8, len(x)), rng.randint(0, 10_000, len(x))
    for lo in range(0, len(x), 50_000):
        hi = min(lo + 50_000, len(x))
        col.upsert([str(i) for i in range(lo, hi)], x[lo:hi],
                   [{"category": f"cat-{c}", "price": float(p) / 100}
                    for c, p in zip(cats[lo:hi], prices[lo:hi])])
    server = QuantixarHTTPServer(QuantixarService(db), port=0).start()
    remote = QuantixarClient(server.url, timeout=120).collection("sharded")
    batch, singles = q[:QUERY_BATCH], q[:512]

    def fan_out():
        def worker(t):
            for i in range(t, len(singles), 32):
                remote.query(singles[i]).top_k(K).run()
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    col.query(batch).top_k(K).run()           # warm-up: corpora to device
    remote.query(batch[:64]).top_k(K).run()
    fan_out()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for span, fn in (
                ("embedded_batch", lambda: col.query(batch).top_k(K).run()),
                ("http_batch", lambda: remote.query(batch).top_k(K).run()),
                ("http_single_512", fan_out)):
            with record_function(f"span::{span}"):
                fn()
                if on_card:
                    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = col.stats()
    server.shutdown()
    dev, total_dev = span_rows(prof, {})
    print(json.dumps({"phase": "H", "wall_s_profiled": wall,
                      "device_events": len(dev), "device_ms": total_dev,
                      "mean_batch": stats["serving_requests_served"]
                      / max(1, stats["serving_batches_served"])}),
          flush=True)
    if on_card and not dev:
        print("profile_torch: the profiler recorded no device events",
              file=sys.stderr)
        return 1
    return 0


def profile_distributed(args, x, q) -> int:
    """Phase I: the distributed search at world 1 (NCCL on the card, gloo
    on the CPU) under quantixar-db's settings, one 1,024-query batch per
    scan after a warm-up; and the same batch with one process playing the
    2 row x 2 model shards of "dims" mode (``emulate_search``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs.quantixar_db import CONFIG as DB
    from repro_torch.core import (BinaryQuantizer, BQConfig, PQConfig,
                                  ProductQuantizer, normalize)
    from repro_torch.distributed import search as ds
    from repro_torch.launch.mesh import make_local_mesh

    on_card = args.device != "cpu"
    mesh = make_local_mesh(1, 1, device=args.device)
    x_raw = torch.as_tensor(x, device=args.device)
    pq = ProductQuantizer(PQConfig(m=DB.pq_m, k=DB.pq_k, metric=DB.metric),
                          device=args.device)
    pq.train(x_raw, seed=0)
    bq = BinaryQuantizer(BQConfig(bits=DB.bq_bits), device=args.device)
    bq.train(x_raw, seed=0)
    raw = torch.as_tensor(q[:QUERY_BATCH], device=args.device)
    w = bq.config.words
    # span -> (kind, scan metric, corpus, queries, feature width, maker)
    scans = {
        "flat_cosine": ("flat", "dot", normalize(x_raw), normalize(raw), 128,
                        lambda: ds.make_flat_search(mesh, k=DB.k,
                                                    metric="cosine")),
        "flat_l2": ("flat", "l2", x_raw, raw, 128,
                    lambda: ds.make_flat_search(mesh, k=DB.k, metric="l2")),
        "pq": ("pq", "adc", pq.encode(x_raw), pq.lut(raw), DB.pq_m,
               lambda: ds.make_pq_search(mesh, k=DB.k)),
        "bq": ("hamming", "hamming", bq.encode(x_raw), bq.encode(raw), w,
               lambda: ds.make_hamming_search(mesh, k=DB.k))}
    runs = []
    for name, (kind, metric, xs, qs, width, make) in scans.items():
        fn = make()
        runs.append((name, lambda fn=fn, xs=xs, qs=qs: fn(xs, qs)))
        runs.append((name + "_dims_2x2", lambda kind=kind, metric=metric,
                     xs=xs, qs=qs, width=width: ds.emulate_search(
                         kind, metric, xs, qs, DB.k,
                         {"data": 2, "model": 2}, "dims", width)))
    for _, fn in runs:                        # warm-up: NCCL, caches
        fn()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for span, fn in runs:
            with record_function(f"span::{span}"):
                fn()
                if on_card:
                    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev, total_dev = span_rows(prof, {})
    print(json.dumps({"phase": "I", "wall_s_profiled": wall,
                      "device_events": len(dev), "device_ms": total_dev}),
          flush=True)
    torch.distributed.destroy_process_group()
    if on_card and not dev:
        print("profile_torch: the profiler recorded no device events",
              file=sys.stderr)
        return 1
    return 0


def profile_xlstm(args) -> int:
    """Phase F: one full-width xlstm-1.3b prefill of 8 x 2,048 tokens."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import zipf_tokens
    from repro_torch.kernels import slstm
    from repro_torch.models import forward, init_params
    from repro_torch.models import recurrent

    on_card = args.device != "cpu"
    cfg = get_config("xlstm-1.3b")
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    model = init_params(cfg, generator=gen, device=args.device)
    toks = torch.as_tensor(zipf_tokens(np.random.RandomState(0), (8, 2048),
                                       cfg.vocab_size), device=args.device)
    forward(model, {"tokens": toks[:, :256]}, cfg)     # warm-up

    def sync():
        if on_card:
            torch.cuda.synchronize()

    chunk = recurrent._mlstm_chunk

    def chunk_in_span(*a):
        with record_function("span::mlstm_chunk"):
            out = chunk(*a)
            sync()
        return out

    recurrent._mlstm_chunk = chunk_in_span
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    sync()
    before = slstm.launches
    try:
        with profile(activities=acts) as prof:
            with record_function("span::prefill"):
                forward(model, {"tokens": toks}, cfg)
                sync()
    finally:
        recurrent._mlstm_chunk = chunk
    launches = slstm.launches - before

    prefill, chunks, dev = None, [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.name().startswith("span::"):
                dev.append((e.start_ns(), e.duration_ns(), e.name()))
        elif e.name() == "span::prefill":
            prefill = (e.start_ns(), e.end_ns())
        elif e.name() == "span::mlstm_chunk":
            chunks.append((e.start_ns(), e.end_ns()))
    chunks.sort()
    starts = [lo for lo, _ in chunks]

    def in_chunk(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < chunks[i][1]

    names, in_loop = collections.Counter(), collections.Counter()
    for start, dur, name in dev:
        if prefill[0] <= start < prefill[1]:
            names[name] += dur
            if in_chunk(start):
                in_loop[name] += dur

    def ms(counter, pred=lambda n: True):
        return sum(v for n, v in counter.items() if pred(n)) / 1e6

    def is_gemm(n):
        return any(p in n.lower() for p in GEMM_PARTS)

    wall = (prefill[1] - prefill[0]) / 1e6
    device = ms(names)
    print(json.dumps({
        "phase": "F", "tokens": 8 * 2048, "wall_ms": wall,
        "device_ms": device, "busy": device / wall if wall else None,
        "host_ms": wall - device,
        "slstm_ms": ms(names, lambda n: is_kernel(KERNELS["slstm"], n)),
        "slstm_launches": launches,
        "mlstm_chunk_loop_ms": ms(in_loop), "mlstm_chunks": len(chunks),
        "matmul_ms": ms(names, is_gemm),
        "matmul_in_chunk_loop_ms": ms(in_loop, is_gemm),
        "top": [[n[:80], v / 1e6] for n, v in names.most_common(10)]}),
        flush=True)
    if on_card and not dev:
        print("profile_torch: the profiler recorded no device events",
              file=sys.stderr)
        return 1
    return 0


def profile_lm(args) -> int:
    """Phase J: one full-size qwen2-1.5b prefill of 8 x 2,048 tokens, its
    device time split into the attention core, the other matrix products
    and the rest.  Phase K: one
    granite-moe-3b-a800m prefill of 2 x 2,048 tokens, the MoE layers'
    device time split into the experts' products and the routing's
    dispatch / combine."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import zipf_tokens
    from repro_torch.models import forward, init_params
    from repro_torch.models import layers as L

    on_card = args.device != "cpu"
    arch, b = (("qwen2-1.5b", 8) if args.phase == "J"
               else ("granite-moe-3b-a800m", 2))
    cfg = get_config(arch)
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    model = init_params(cfg, generator=gen, device=args.device)
    toks = torch.as_tensor(zipf_tokens(np.random.RandomState(0), (b, 2048),
                                       cfg.vocab_size), device=args.device)
    forward(model, {"tokens": toks[:, :256]}, cfg)     # warm-up

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # each span's function, wrapped in a record_function closed by a sync
    spans = ({"attention": ("_sdpa", "_chunked_attention",
                            "_extent_attention")}
             if args.phase == "J" else
             {"moe": ("_route_groups",), "experts": ("_experts",)})
    saved = {}

    def wrap(label, name):
        fn = getattr(L, name)

        def inner(*a, **kw):
            with record_function(f"span::{label}"):
                out = fn(*a, **kw)
                sync()
            return out
        return inner

    for label, names in spans.items():
        for name in names:
            saved[name] = getattr(L, name)
            setattr(L, name, wrap(label, name))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    sync()
    try:
        with profile(activities=acts) as prof:
            with record_function("span::prefill"):
                forward(model, {"tokens": toks}, cfg)
                sync()
    finally:
        for name, fn in saved.items():
            setattr(L, name, fn)

    prefill, inside, dev = None, collections.defaultdict(list), []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.name().startswith("span::"):
                dev.append((e.start_ns(), e.duration_ns(), e.name()))
        elif e.name() == "span::prefill":
            prefill = (e.start_ns(), e.end_ns())
        elif e.name().startswith("span::"):
            inside[e.name()[6:]].append((e.start_ns(), e.end_ns()))
    for v in inside.values():
        v.sort()

    def in_span(label, t):
        iv = inside[label]
        i = bisect.bisect_right([lo for lo, _ in iv], t) - 1
        return i >= 0 and t < iv[i][1]

    def is_gemm(n):
        return any(p in n.lower() for p in GEMM_PARTS)

    names, by_span = collections.Counter(), collections.defaultdict(
        collections.Counter)
    for start, dur, name in dev:
        if prefill[0] <= start < prefill[1]:
            names[name] += dur
            for label in spans:
                if in_span(label, start):
                    by_span[label][name] += dur

    def ms(counter, pred=lambda n: True):
        return sum(v for n, v in counter.items() if pred(n)) / 1e6

    wall = (prefill[1] - prefill[0]) / 1e6
    device = ms(names)
    rec = {"phase": args.phase, "model": arch, "layers": cfg.n_layers,
           "tokens": b * 2048, "wall_ms": wall, "device_ms": device,
           "busy": device / wall if wall else None,
           "host_ms": wall - device, "matmul_ms": ms(names, is_gemm)}
    if args.phase == "J":
        core = by_span["attention"]
        rec.update({
            "attention_core_ms": ms(core),
            "attention_core_matmul_ms": ms(core, is_gemm),
            "attention_spans": len(inside["attention"]),
            "other_matmul_ms": ms(names, is_gemm) - ms(core, is_gemm),
            "other_elementwise_ms": (device - ms(core)
                                     - (ms(names, is_gemm) - ms(core,
                                                                is_gemm)))})
    else:
        moe, experts = by_span["moe"], by_span["experts"]
        rec.update({"moe_ms": ms(moe), "experts_ms": ms(experts),
                    "dispatch_combine_ms": ms(moe) - ms(experts),
                    "moe_waves": len(inside["moe"]),
                    "moe_dispatch": cfg.moe_dispatch})
    rec["top"] = [[n[:80], v / 1e6] for n, v in names.most_common(10)]
    print(json.dumps(rec), flush=True)
    if on_card and not dev:
        print("profile_torch: the profiler recorded no device events",
              file=sys.stderr)
        return 1
    return 0


def profile_train(args) -> int:
    """Phase L: one train step of xlstm-1.3b and of qwen2-1.5b, its device
    time split into forward, recompute, backward (by the units' block
    pattern), logits and CE, AdamW, B8 / B8ᵀ and the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.kernels import slstm
    from repro_torch.models import init_train_state, make_train_step
    from repro_torch.models import model as model_mod
    from repro_torch.models import steps as steps_mod
    from repro_torch.optim import AdamWConfig, adamw

    on_card = args.device != "cpu"
    b, s = args.train_batch, args.train_seq

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # a span synchronizes as it opens and as it closes, so that the work
    # queued before it does not run inside it
    def spanned(fn, label):
        def inner(*a, **kw):
            sync()
            with record_function(f"span::{label(*a)}"):
                out = fn(*a, **kw)
                sync()
            return out
        return inner

    in_backward = [False]

    def unit_label(blocks, *_):
        kinds = collections.Counter(blk.block_type for blk in blocks)
        kind = " + ".join(f"{k} x{v}" if v > 1 else k
                          for k, v in kinds.items())
        return f"{'recompute' if in_backward[0] else 'forward'}::{kind}"

    def backward(*a, **kw):
        in_backward[0] = True
        sync()
        try:
            with record_function("span::backward"):
                out = saved["backward"](*a, **kw)
                sync()
        finally:
            in_backward[0] = False
        return out

    saved = {"unit": model_mod._apply_unit,
             "logits": model_mod.logits_from_hidden,
             "ce": steps_mod.cross_entropy,
             "adamw": adamw.apply_updates,
             "backward": torch.autograd.backward}
    status = 0
    for arch in ("xlstm-1.3b", "qwen2-1.5b"):
        cfg = get_config(arch)
        gen = torch.Generator(device=args.device)
        gen.manual_seed(0)
        state = init_train_state(cfg, generator=gen, device=args.device)
        step = make_train_step(cfg, AdamWConfig(lr=3e-4, total_steps=6,
                                                warmup_steps=1))
        data = lm_batches(cfg.vocab_size, b, s, seed=0)

        def batch():
            nb = next(data)
            return {k: torch.as_tensor(getattr(nb, k), device=args.device)
                    for k in ("tokens", "targets", "segment_ids")}

        state, m = step(state, batch())          # warm-up
        float(m["loss"])
        nxt = batch()
        before = (slstm.launches, slstm.backward_launches)
        model_mod._apply_unit = spanned(saved["unit"], unit_label)
        model_mod.logits_from_hidden = spanned(saved["logits"],
                                               lambda *_: "logits_ce")
        steps_mod.cross_entropy = spanned(saved["ce"],
                                          lambda *_: "logits_ce")
        adamw.apply_updates = spanned(saved["adamw"], lambda *_: "adamw")
        torch.autograd.backward = backward
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        sync()
        try:
            with profile(activities=acts) as prof:
                with record_function("span::step"):
                    state, m = step(state, nxt)
                    loss = float(m["loss"])
                    sync()
        finally:
            model_mod._apply_unit = saved["unit"]
            model_mod.logits_from_hidden = saved["logits"]
            steps_mod.cross_entropy = saved["ce"]
            adamw.apply_updates = saved["adamw"]
            torch.autograd.backward = saved["backward"]
        b8 = slstm.launches - before[0]
        b8t = slstm.backward_launches - before[1]

        stepspan, spans, dev = None, [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                if not e.name().startswith("span::"):
                    dev.append((e.start_ns(), e.duration_ns(), e.name()))
            elif e.name() == "span::step":
                stepspan = (e.start_ns(), e.end_ns())
            elif e.name().startswith("span::"):
                spans.append((e.start_ns(), e.end_ns(), e.name()[6:]))
        spans.sort()
        recomputes = [sp for sp in spans if sp[2].startswith("recompute")]
        rec_ends = [hi for _, hi, _ in recomputes]

        def bucket(t):
            inner = [lab for lo, hi, lab in spans if lo <= t < hi]
            inner = [lab for lab in inner if lab != "backward"] or inner
            if not inner:
                return "other"
            lab = inner[-1]
            if lab != "backward":
                return lab
            i = bisect.bisect_right(rec_ends, t) - 1
            if i < 0:
                return "backward::logits_ce"
            return "backward::" + recomputes[i][2].split("::", 1)[1]

        names, buckets = collections.Counter(), collections.Counter()
        for start, dur, name in dev:
            if stepspan[0] <= start < stepspan[1]:
                names[name] += dur
                buckets[bucket(start)] += dur

        def ms(counter, pred=lambda n: True):
            return sum(v for n, v in counter.items() if pred(n)) / 1e6

        def by(prefix):
            return {k.split("::", 1)[1]: v / 1e6 for k, v in buckets.items()
                    if k.startswith(prefix + "::")}

        wall = (stepspan[1] - stepspan[0]) / 1e6
        device = ms(names)
        print(json.dumps({
            "phase": "L", "model": arch, "layers": cfg.n_layers,
            "tokens": b * s, "loss": loss, "wall_ms": wall,
            "device_ms": device, "busy": device / wall if wall else None,
            "host_ms": wall - device,
            "forward_ms": by("forward"), "recompute_ms": by("recompute"),
            "logits_ce_ms": buckets["logits_ce"] / 1e6,
            "backward_ms": {k: v for k, v in by("backward").items()
                            if k != "logits_ce"},
            "backward_logits_ce_ms": buckets["backward::logits_ce"] / 1e6,
            "adamw_ms": buckets["adamw"] / 1e6,
            "other_ms": buckets["other"] / 1e6,
            "b8_ms": ms(names, functools.partial(
                is_kernel, KERNELS["slstm_forward"])),
            "b8_launches": b8,
            "b8t_ms": ms(names, functools.partial(
                is_kernel, KERNELS["slstm_backward"])),
            "b8t_launches": b8t,
            "recompute_spans": len(recomputes),
            "top": [[n[:80], v / 1e6] for n, v in names.most_common(12)]}),
            flush=True)
        if on_card and not dev:
            print("profile_torch: the profiler recorded no device events",
                  file=sys.stderr)
            status = 1
        del state, m, prof
        if on_card:
            torch.cuda.empty_cache()
    return status


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--phase", choices=[*sorted(QUANT), "F", "H", "I", "J",
                                        "K", "L"], default="A")
    ap.add_argument("--train-batch", type=int, default=8)
    ap.add_argument("--train-seq", type=int, default=2048)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import tracing
    from repro_torch.core import (BQConfig, EngineConfig, IVFConfig,
                                  PQConfig, QuantixarEngine)
    from repro_torch.data.synthetic import sift_like
    from repro_torch.kernels import _build

    on_card = args.device != "cpu"
    if on_card:
        _build.build()
    if args.phase == "F":
        with torch.no_grad():
            return profile_xlstm(args)
    if args.phase in ("J", "K"):
        with torch.no_grad():
            return profile_lm(args)
    if args.phase == "L":
        return profile_train(args)
    x = sift_like(args.n, seed=0)
    q = sift_like(10_000, seed=1)[: args.queries]
    if args.phase == "E":
        return profile_exact(args, x, q)
    if args.phase == "H":
        return profile_cluster(args, x, q)
    if args.phase == "I":
        return profile_distributed(args, x, q)
    eng = QuantixarEngine(EngineConfig(
        dim=x.shape[1], metric="cosine",
        index="ivf" if args.phase == "G" else "hnsw",
        quantization=QUANT[args.phase], pq=PQConfig(m=16, k=256),
        bq=BQConfig(bits=256), builder="bulk",
        ivf=IVFConfig(nlist=IVF_NLIST, nprobe=IVF_NPROBE)),
        device=args.device)
    eng.add(x)

    # one record_function span per build phase, closed at the phase's last
    # progress mark and named after it; the device events are assigned to
    # spans by start time
    spans, labels = [], {}

    def open_span():
        rf = record_function(f"span::build{len(labels)}")
        rf.__enter__()
        spans.append(rf)

    def close_span(label):
        labels[f"build{len(labels)}"] = label
        spans.pop().__exit__(None, None, None)

    def progress(phase, done, total):
        if done == total:
            close_span(phase)
            open_span()

    # one batch under a ~5 % mask: the flat route (pq_adc / hamming in C / D)
    mask5 = np.random.RandomState(7).random_sample(len(x)) < 0.05
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        open_span()
        eng.build(progress=progress)
        if on_card:
            torch.cuda.synchronize()
        close_span("repair+pack")
        with record_function("span::search"):
            tracing.clear()
            for lo in range(0, len(q), QUERY_BATCH):
                eng.search(q[lo: lo + QUERY_BATCH], K, ef=EF,
                           expansion_width=WIDTH)
            if on_card:
                torch.cuda.synchronize()
            searched = tracing.summary()
        if args.phase == "G":
            with record_function("span::search_again"):
                for lo in range(0, len(q), QUERY_BATCH):
                    eng.search(q[lo: lo + QUERY_BATCH], K, ef=EF,
                               expansion_width=WIDTH)
                if on_card:
                    torch.cuda.synchronize()
        with record_function("span::flat_route"):
            eng.search(q[:QUERY_BATCH], K, mask=mask5)
            if on_card:
                torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()

    dev, total_dev = span_rows(prof, labels)
    step = searched["spans"].get("hnsw.step")
    if step is not None:
        c = step["counts"]
        batches = -(-len(q) // QUERY_BATCH)
        print(json.dumps({
            "span": "search_steps", "steps_per_batch": step["n"] / batches,
            "fresh_share": c["fresh"] / c["slots"],
            "active_share": c["active"] / c["queries"],
            "host_ms_per_step": 1e3 * (step["s"] - step["wait_s"])
            / step["n"],
            "wait_ms_per_batch": 1e3 * searched["wait_s"] / batches,
            "spans_dropped": searched["dropped"]}), flush=True)
    print(json.dumps({"phase": args.phase, "wall_s_profiled": wall, "device_events": len(dev),
                      "device_ms": total_dev,
                      "analysis_s": time.perf_counter() - t1,
                      "build_stats": {k: v for k, v in eng.stats().items()
                                      if k.startswith(("build", "ivf"))}}),
          flush=True)
    if on_card and not dev:
        print("profile_torch: the profiler recorded no device events",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
