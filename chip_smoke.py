#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

(``--kernels`` runs the kernel checks of B1-B7 alone and prints their rows,
B4's stage split among them.)

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version on the card at the main paths' shapes, and
then drives five collections end to end through
``repro_torch.core.QuantixarEngine``, three through the public API (one of
them sharded, behind the HTTP server), the distributed search through
``repro_torch.distributed`` and the language models through
``repro_torch.models`` (xLSTM, then the nine other families):

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
  phase D  the same with BQ codes (256 bits); every layer-0 step runs B4's
           fused entry (``beam_gather_hamming_masked``), which one batch
           under ``torch.profiler`` times in the path and whose inputs at
           four of that batch's steps it is held and timed on;
  phase E  phase A's corpus, queries and ground truth through
           ``repro_torch.api.Database`` on the card: an exact (flat)
           cosine collection with keyword, numeric, bool and text fields
           (string-id upserts timed as rows/s, batched, single-vector
           through the batcher from 32 threads, filtered, delete and
           replace, hybrid text + vector), the default HNSW collection
           (build on first query, recall at ef 64 / 256, delta rows), and
           save / load of both;
  phase F  xlstm-1.3b (``src/repro_torch/configs/xlstm_1_3b.py``: 48 layers,
           d_model 2048, 4 heads, 7 mLSTM : 1 sLSTM) at full width through
           ``repro_torch.models`` on the card, random weights from a seeded
           ``torch.Generator``: 8 prompts of 2,048 tokens through
           ``forward`` (prefill / scoring, tokens/s, peak memory), 8 prompts
           of 128 tokens teacher-forced through the greedy
           ``make_serve_step`` and then 32 generated tokens each (ms per
           step), and in fp32 ``forward`` on the ``slstm`` kernel against
           ``forward(force_ref=True)`` and teacher-forced ``decode_step``
           against ``forward``;
  phase G  phase A's corpus, queries, ground truth and delta rows in an IVF
           engine (cosine, nlist 1,024, nprobe 32, the other IVF knobs at
           their defaults): k-means and list build, 10,000 queries in
           batches of 1,024 at k=10 held to recall@10, delta rows, masked
           searches at ~50 % (the probed lists) and ~5 % (the flat route),
           and ``state_dict`` / ``from_state_dict`` on the card; the coarse
           probe runs B5's matrix entry and its top-k (k = nprobe is past
           the fused entry's fast k on 1,024 centroids), the probed lists
           B1's list-major entry (``beam_gather_lists``), and each is held
           to its plain version and timed on the phase's own inputs (the
           probes' queries and centroids, the probes and lists), the
           list-major entry bit for bit against B1's gather entry over the
           same candidates, which it replaced;
  phase H  phase E's exact collection schema at ``shards=4, replicas=2``
           over phase A's corpus by string id (eight engines on the card),
           held hit for hit to a single-engine collection over the same
           rows, embedded and through ``QuantixarService`` + the HTTP server
           on 127.0.0.1 + ``QuantixarClient``; 2,048 single-vector queries
           over HTTP from 32 threads of a client process of its own
           (``scripts/http_load.py``: p50 / p99, mean coalesced batch,
           each answer held to the batch's hits and to exact recall), a
           replica failover, and save / load of the sharded database; B5
           is held to its plain version on one shard's scans at Q = 1,024
           and 32.
  phase I  the distributed search (``repro_torch.distributed``) under
           ``quantixar-db``'s settings (k=100, batches of 1,024) over phase
           A's corpus and queries: flat cosine (-q.x on unit rows), flat
           l2, PQ and BQ (phase C and D's quantizers, by ``state_dict``),
           at world 1 on NCCL in "rows" and "dims" mode, the query batches
           through ``device_put_batches``: QPS, the flat ids held to the
           plain exact top-k (recall@100) and PQ / BQ to the quantizers'
           exact scans; then one process plays the ranks of 4 row shards
           (bit-equal to world 1) and of 2 row x 2 model shards (equal up
           to ties and tolerance) through the module's per-rank functions;
  phase J  qwen2-1.5b (``src/repro_torch/configs/qwen2_1_5b.py``: 28 layers,
           d_model 1536, 12 heads, 2 kv heads, vocab 151,936) at its full
           published size, random weights from a seeded ``torch.Generator``:
           8 prompts of 2,048 Zipf tokens through ``forward`` in bf16 (the
           chunked attention route; tokens/s, peak memory), the greedy
           ``make_serve_step`` at batch 8 (128 teacher-forced + 32 generated
           tokens) in "ragged" and "uniform" ``decode_pos_mode`` (the same
           ids), the fp32 check (teacher-forced ``decode_step`` against
           ``forward`` at 8 x 128), and the attention yardstick: the port's
           attention against ``F.scaled_dot_product_attention`` on the same
           q, k and v (the library call on no path);
  phase K  the other eight new families (qwen3-4b, stablelm-3b,
           granite-moe-3b-a800m, seamless-m4t-medium, recurrentgemma-9b,
           starcoder2-15b, mixtral-8x7b, chameleon-34b) at their published
           widths, depth cut only where the fp32 weights would not fit on
           the card (each cut, with the sizes that force it, in the
           family's ``reduced``): a bf16 prefill of 2 x 2,048 tokens (seamless
           with 2 x 1,024 seeded frames), 16 greedy steps after a 32-token
           teacher-forced prompt, and the fp32 check at 2 x 64 (the MoE
           families with ``moe_capacity_factor=8`` and seamless with
           ``rope_pct=0``, which remove two known properties of the
           reference, printed under ``reduced``).  J and K run no kernel of
           the port: the reference computes these blocks in plain ``jnp``;
  phase L  training at full width through ``repro_torch.launch.train``,
           random weights from a seeded ``torch.Generator``, fp32 master
           weights, activations in the config's dtype, each pattern unit
           recomputed in the backward: xlstm-1.3b (48 layers, d_model 2048;
           every sLSTM layer's forward on B8's saving entry and its backward
           on B8ᵀ's cluster path, ``slstm_backward``) for 6 steps of 8 x
           2,048 tokens of the ``lm_batches`` stream (step wall and device
           ms, tokens/s, peak memory, model-FLOP share of the dense bf16
           peak), every loss finite and the last below the first, then the fp32 gradient
           check at 2 x 256 (every parameter's gradient with B8 + B8ᵀ
           against ``force_ref=True``); qwen2-1.5b at full size (the
           launcher's default arch) the same 6 steps, 2 steps with
           ``grad_compress`` at the same 8 x 2,048 (expandable segments
           for those two, COMPRESS_ALLOC), and a kill at step 3 and a
           resume from the step-2 generation through ``ckpt_dir`` at 2 of
           its 28 layers (printed under ``reduced``: a generation of the
           full depth would be 17.2 GiB on disk).  The serving phases F, J and K run under
           ``torch.no_grad()``;
  phase N  the dry run (``repro_torch.launch.dryrun``), in child processes
           on the host's CPU, started once phase 1's kernel rows are timed
           (niced, on the upper half of the cores this process may use)
           and run beside phases A-L: qwen2-1.5b and
           xlstm-1.3b at every shape on the single-pod production mesh
           (16 x 16, a fake process group, meta tensors), base and opt, and
           the six quantixar-db cells, every record ok or the reference's
           skip; its peak for phase L2's own cell (8 x 2,048 at a (1, 1)
           mesh) beside L2's measured ``max_memory_allocated``, their ratio
           within ``N_PEAK_RATIO``; and in J, J's greedy decode through
           ``make_serve_step`` on the model placed at a (1, 1) mesh from a
           decode state placed by the serve specs: J's ids.

Every phase must pass and every kernel of its path must have launched, or
the script exits non-zero.  The exact scans of phases A-E (delta segment,
flat route, flat index) run B5's fused entry (``l2_topk``: distances and
their top-k in one launch over the whole corpus), and phase E's k = 1,000
query, C and D's delta scans (k = 40 over 8,192 rows) and G's coarse probe
its matrix entry (``l2_distance``) and ``topk_smallest``; every sLSTM
layer of phase F's prefill runs the ``slstm`` kernel, and every sLSTM
layer of phase L's train steps B8's saving entry and B8ᵀ
(``slstm_backward``: its cluster path at xlstm-1.3b's head width, every
launch checked), which phase F holds to its plain version (the explicit
reverse loop) at B8's check shapes, on both of its paths, and at F's
shape.  Before the last
line it prints the card's name and power limit and one JSON line with each
kernel's launches, error, time, plain-version time, bound and library-call
time; the last line is the device JSON.  A kernel's ``ms`` is its device
time: CUDA events around a CUDA graph of many calls over rotating input
sets, divided by the count (`device_ms`); ``call_ms`` is what one call
costs its caller, host included (`time_ms`).  It needs a CUDA device and the
repository's ``src/`` beside it, and fails without either.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# every result line also goes here (git-ignored), for runs whose console
# output is cut short
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# dense TF32 on the tensor cores; B5's 3xTF32 does three per fp32 product
TF32_FLOP_PER_S = 495e12
# dense bf16 on the tensor cores (phase J's attention yardstick)
BF16_FLOP_PER_S = 989e12
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
# the device timer (`device_ms`): input sets taken in turn, work per graph
# replay, the most calls a graph holds, replays timed; plain versions whose
# one call is longer than PLAIN_GRAPH_MAX_MS keep their per-call time
SETS = 4
DEVICE_WINDOW_MS = 20.0
DEVICE_MAX_REPS = 200
DEVICE_REPLAYS = 5
PLAIN_GRAPH_MAX_MS = 5.0

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
# k of the fused entry's sweep against the route it replaced (topk_k_sweep)
TOPK_SWEEP_K = (16, 17, 64, 65, 100, 101, 128, 256)
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
# (l2_topk, B5's fused entry: the exact scans at k up to its fast k, the
# delta scan and, in A, B and E, the exact flat route and the flat index;
# l2_distance, its matrix entry: E's k = 1,000 query, past FUSED_MAX_K,
# and scans of at most MATRIX_MAX_N rows past the fast k: C and D's delta
# scans at k = 40 (the rescore's fetch), G's coarse probe at k = 32 and
# the partial distances of I's "dims" ranks; pq_adc and hamming in I, the
# PQ and BQ scans of every rank)
PHASE_KERNELS = {
    "A": ("beam_gather", "pair_gather", "l2_topk"),
    "B": ("beam_gather", "pair_gather", "l2_topk"),
    "C": ("beam_gather", "pair_gather", "beam_gather_adc", "pq_adc",
          "l2_distance"),
    "D": ("beam_gather", "pair_gather", "beam_gather_hamming_masked",
          "hamming", "l2_distance"),
    "E": ("beam_gather", "pair_gather", "l2_topk", "l2_distance"),
    "F": ("slstm",),
    "G": ("beam_gather_lists", "l2_distance", "l2_topk"),
    "H": ("l2_topk",),
    "I": ("l2_topk", "l2_distance", "pq_adc", "hamming"),
    "L": ("slstm", "slstm_backward")}
# kernels whose source file is named otherwise: B5's two entries share one,
# and B4's
SOURCES = {"l2_topk": "l2_distance",
           "beam_gather_hamming_masked": "beam_gather_hamming",
           "beam_gather_lists": "beam_gather"}
# a kernel row's launches: the counters of every entry of its source that
# ran it (B4's kernel runs in phase D through its fused entry only, B1's in
# phase G through its list-major entry only)
ENTRIES = {"beam_gather_hamming": ("beam_gather_hamming",
                                   "beam_gather_hamming_masked"),
           "beam_gather": ("beam_gather", "beam_gather_lists")}
# B4's fused entry in phase 1: PAD on this share of the slots (never
# fresh) and fresh on this share of the rest, at L > 1 (L = 1, the entry
# point's call, is all fresh)
B4_PAD_SHARE, B4_FRESH_SHARE = 0.125, 0.5
# phase E: the exact collection's fields and its checks' sizes
N_CATEGORIES = 8         # KeywordField("category"): cat-0 .. cat-7
TITLE_VOCAB = 5_000      # TextField("title"): 4 words from this vocabulary
UPSERT_BATCH = 50_000
SINGLE_QUERIES = 2_048   # single-vector queries through the batcher
SINGLE_THREADS = 32
EXACT_RECALL_FLOOR = 0.999
# phase F: xlstm-1.3b serving at full width (48 layers: 6 of them sLSTM)
XLSTM = "xlstm-1.3b"
PREFILL_B, PREFILL_S = 8, 2048
PROMPT_S, GEN_TOKENS = 128, 32
# B8 against its plain version: |h| <= 1 (c / n is a weighted mean of tanh
# values); fp32 differs by summation order, bf16 by at most one ulp at 1
SLSTM_ATOL = {"float32": 1e-4, "bfloat16": 7.9e-3}
# the fp32 end-to-end checks: kernel vs plain forward, decode vs forward
LOGIT_REL_TOL = 1e-3
ARGMAX_AGREEMENT = 0.99
# the port's chunked attention against scaled_dot_product_attention, bf16
# q, k, v: the largest difference at a position over that position's largest
# output.  Both round the output to bf16 (2^-9 relative) and the port rounds
# the softmax weights and each chunk's PV product to bf16 as the reference
# does (2^-9 each), so a few such roundings fit; a wrong kv chunk moves a
# late position by about its whole size
ATTN_REL_TOL = 0.02
# phases J and K: the attention, MoE, RG-LRU and encoder-decoder families
# (J: qwen2-1.5b at its full size, F's prefill and generation sizes; K: the
# other eight at their published widths, a prefill of 2 x 2,048 tokens, a
# 32-token teacher-forced prompt and 16 generated tokens, the fp32 check at
# 2 x 64)
QWEN2 = "qwen2-1.5b"
K_PREFILL_B, K_FRAMES = 2, 1024
K_PROMPT_S, K_GEN_TOKENS = 32, 16
K_CHECK_S = 64
K_FAMILIES = ("qwen3-4b", "stablelm-3b", "granite-moe-3b-a800m",
              "seamless-m4t-medium", "recurrentgemma-9b", "starcoder2-15b",
              "mixtral-8x7b", "chameleon-34b")
# each family runs at the deepest depth (at most its published one) whose
# fp32 weights fit in the card's free memory less this reserve for the
# prefill's activations and logits: the most K's families took beside their
# weights was 10.8 GiB (recurrentgemma-9b's 256,000-wide logits, NVIDIA H100
# 80GB HBM3)
K_RESERVE_GIB = 16.0
# the fp32 decode-vs-forward check runs without the reference's two known
# properties (ROADMAP queue C): each override removes one
K_AGREE_OVERRIDES = {"granite-moe-3b-a800m": {"moe_capacity_factor": 8.0},
                     "mixtral-8x7b": {"moe_capacity_factor": 8.0},
                     "seamless-m4t-medium": {"rope_pct": 0.0}}
K_AGREE_WHY = {
    "moe_capacity_factor": "forward drops tokens past the experts' "
                           "capacity, a decode step of one token none",
    "rope_pct": "forward rotates the cross-attention queries, decode does "
                "not"}
# phase F: B8ᵀ (the sLSTM backward) against its plain reverse loop on the
# same saved forward and cotangent, per-tensor relative L2: fp32 within 1e-4
# (summation order over up to 2,048 sequential steps).  With bf16 gates both
# round their f32 dpre, which agree within 1e-4, to bf16: the two differ
# only where the f32 values straddle a rounding boundary, by one bf16 step
# (2^-8 relative) on those few elements, so 1e-3 for dgates (2.1e-5 on the
# H100, PERF.md) and 1e-4 for the f32 dpre, dr and db
SLSTM_BWD_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}
# phase L: training at full width (xlstm-1.3b, then qwen2-1.5b, the
# launcher's default arch): 6 steps of 8 x 2,048 tokens at lr 3e-4; the
# step times are the median of steps 2-6
TRAIN_STEPS, TRAIN_B, TRAIN_S, TRAIN_LR = 6, 8, 2048, 3e-4
# the fp32 gradient check of L1 at 2 x 256: B8 + B8ᵀ against the plain
# recurrence and reverse loop through the whole model.  Loss within 1e-5
# relative (fp32 sums in another order, one forward); every parameter's
# gradient within 1e-3 relative L2 (the order differences of 6 sLSTM
# layers' 256 steps, carried back through 48 layers)
GRAD_CHECK_B, GRAD_CHECK_S = 2, 256
GRAD_LOSS_RTOL, GRAD_REL_L2 = 1e-5, 1e-3
# L2's two grad_compress steps run at 8 x 2,048 too: the error feedback
# (5.75 GiB of f32) on top of the step's 65.7 GiB peak (its 9.27 GiB of
# fp32 logits and as much again for their gradient) fits the H100's 79.18
# GiB, but the caching allocator's blocks, split around those 9.27 GiB
# tensors, left 19.4 GiB reserved and unusable and the second step ran out
# of memory; expandable segments map freed pages into one range, so these
# two steps run with them (and only these: A-L1 keep the default)
COMPRESS_ALLOC = "expandable_segments:True"
# L2's kill and resume: a generation holds params, m and v in fp32, 17.2
# GiB at qwen2-1.5b's 28 layers; at 2 layers (the 233M-parameter embedding
# dominates) 3.65 GiB
RESUME_LAYERS, RESUME_B, RESUME_S = 2, 2, 512
# the model-FLOP share: 6 x the parameters that enter a product x tokens
# (the forward's 2 and the backward's 4; remat's recomputed forward, the
# attention scores and the recurrences are not counted) over the dense bf16
# peak
MODEL_FLOPS_PER_PARAM_TOKEN = 6
# phase G: IVF at SIFT1M's usual setting, nlist ~ sqrt(N) (ann-benchmarks'
# faiss-ivf grid over SIFT-128 holds nlist 1,024 and nprobe in the tens);
# the schema's default nlist 64 would scan 187,504 candidates a query
IVF_NLIST, IVF_NPROBE = 1024, 32
# recall@10 floor at nprobe 32, a margin under the H100 reading (0.82399,
# PERF.md)
IVF_RECALL_FLOOR = 0.80
# B1 at IVF's shape: its plain version would gather (Q, C, D) rows (24.6 GB
# at Q = 1,024), so it is held on this many of the batch's queries
IVF_PLAIN_Q = 64
# B5's two routes on a small corpus (small_topk_sweep): (Q, N, mode,
# corpus, ks): G's coarse probe (1,024 centroids), C and D's delta scans (5,000
# rows padded to 8,192: reconstructions in l2, BQ signs in dot), one
# 65,536-row chunk (the flat route's, past MATRIX_MAX_N), and the batcher's
# largest bucket
SMALL_SWEEP = ((1024, 1024, "l2", "raw", (16, 17, 32, 64, 100)),
               (1024, 8192, "l2", "raw", (16, 17, 40, 64)),
               (1024, 8192, "dot", "signs", (16, 17, 40)),
               (1024, 65536, "cosine", "unit", (16, 17, 32, 64, 100)),
               (32, 1024, "l2", "raw", (64, 65, 100)),
               (32, 65536, "cosine", "unit", (64, 65, 100)))
# phase H: the sharded layout: 4 shards, the corpus split of the
# reference's distributed search tests (a data axis of 4,
# tests/test_distributed.py) and its sharded checkpoints
# (tests/test_checkpoint.py), each shard mirrored twice for failover
SHARDS, REPLICAS = 4, 2
# the batcher's largest bucket: B5 is held on a shard's scan at this Q too
SHARD_SMALL_Q = 32
# phase I: the distributed search at quantixar-db's settings
# (src/repro_torch/configs/quantixar_db.py: k 100, query batches of 1,024,
# cosine, PQ m 16 / k 256, BQ 256 bits) at world 1 on NCCL, and one process
# playing the ranks of 4 row shards ("rows", 250,000 rows each) and of 2
# row x 2 model shards ("dims": D 64, m 8, W 4 a rank)
DIST_ROWS = {"data": 4, "model": 1}
DIST_DIMS = {"data": 2, "model": 2}
DIST_REDUCED = ("n: quantixar-db's 100M corpus is its 256-chip production "
                "cell, 390,625 rows a chip; one card at world 1 holds phase "
                "A's 1M, 2.56x a chip's share")
# flat recall@100 of the world-1 search against torch.topk over the plain
# distances (the two differ only in ties and rounding)
DIST_RECALL_FLOOR = 0.999
# the "dims" emulation's PQ distances against world 1's: two sums of 8
# LUT entries added, against one sum of 16 in order (the JAX package's ADC
# tolerance)
PQ_DIMS_RTOL = 1e-5
# a phase's kernel rows, which its summary leaves to the kernels line
ROW_KEYS = ("b1_row", "lists_row", "probe_row", "shard_rows",
            "pq_row", "hamming_row", "l2_rows")


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
    """Per-call time, what a caller pays, host included: the median of
    CUDA events recorded around one call each (the wrapper's checks,
    allocation and launch included), after warm-up.  Reported as
    ``call_ms``."""
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


def device_ms(torch, fns, graph: bool = True) -> float:
    """Device time of one call: CUDA events around one replay of a CUDA
    graph holding R calls, divided by R, the median of DEVICE_REPLAYS
    replays after a warm one.  The graph keeps the wrapper's host work
    (checks, allocation, the launch) from pacing the card.  ``fns`` holds
    one call per input set (SETS of them, taken in turn), so that rows a
    real caller finds cold are not L2-resident from the call before.  R
    makes about DEVICE_WINDOW_MS of work a replay, at least one call per
    set.  ``graph=False`` times R calls issued back to back instead (for
    calls long enough that the host never paces them)."""
    for f in fns:                        # builds, caches, kernel attributes
        f()
    torch.cuda.synchronize()
    one = time_ms(torch, fns[0], reps=3, warmup=0)
    reps = max(1, min(DEVICE_MAX_REPS, int(DEVICE_WINDOW_MS / max(one, 1e-3))))
    reps = len(fns) * -(-reps // len(fns))

    def calls():
        for i in range(reps):
            fns[i % len(fns)]()

    run = calls
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            calls()
        run = g.replay
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(DEVICE_REPLAYS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def timing(torch, fns, prefix: str = "", graph: bool = True,
           reps: int = 25, warmup: int = 3) -> dict:
    """{prefix + "ms": device time (`device_ms`), prefix + "call_ms":
    per-call time (`time_ms`, the first input set)}."""
    return {f"{prefix}ms": device_ms(torch, fns, graph=graph),
            f"{prefix}call_ms": time_ms(torch, fns[0], reps, warmup)}


def plain_timing(torch, fns, reps: int = 25, warmup: int = 3) -> dict:
    """A plain version's times: ``plain_ms`` is its device time where one
    call takes under PLAIN_GRAPH_MAX_MS, else its per-call time, which at
    that length is the device's (``plain_timer`` says which);
    ``plain_call_ms`` the per-call time."""
    call = time_ms(torch, fns[0], reps, warmup)
    if call < PLAIN_GRAPH_MAX_MS:
        return {"plain_ms": device_ms(torch, fns), "plain_call_ms": call,
                "plain_timer": "graph"}
    return {"plain_ms": call, "plain_call_ms": call, "plain_timer": "call"}


def output_digest(t) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes: two
    versions of a kernel that agree bit for bit print the same digest."""
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()) \
        .hexdigest()[:16]


def bound(nbytes: float, ops: float, rate: float = FP32_FLOP_PER_S):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over their peak rate."""
    tb, tf = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version on the card
# ---------------------------------------------------------------------------

def kernel_checks(torch, corpora, log):
    """B1 ``beam_gather`` and B2 ``pair_gather`` against their plain
    versions, on SETS input sets of random ids each (the first one checked,
    all of them timed in turn)."""
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
            # L = 128: search (width 4 x M0 32); 256: the stitch's
            # re-search (width 8 x M0 32)
            for length in (1, 128, 256):
                nq = QUERY_BATCH
                sets = []
                for _ in range(SETS):
                    ids = torch.randint(0, n, (nq, length), generator=gen,
                                        device="cuda", dtype=torch.int32)
                    q = corpus[torch.randint(0, n, (nq,), generator=gen,
                                             device="cuda")]
                    q = q + 0.01 * torch.randn(q.shape, generator=gen,
                                               device="cuda")
                    sets.append((q, ids))
                q, ids = sets[0]
                got = bg.beam_gather(q, ids, corpus, mode=mode)
                want = plain(q, ids, corpus)
                torch.cuda.synchronize()
                err = (got - want).abs()
                tol = RTOL * want.abs() \
                    + ATOL_PER_NORM * q.norm(dim=1)[:, None] * norms[ids.long()]
                check(bool((err <= tol).all()),
                      f"beam_gather {mode} D={d} L={length}: max err "
                      f"{float(err.max())} over tolerance")
                digest = output_digest(got)
                uniq = int(torch.unique(ids).numel())
                nbytes = uniq * d * 4 + nq * d * 4 + nq * length * 8
                flops = nq * length * d * (3 if mode == "l2" else 2)
                b_ms, b_by = bound(nbytes, flops)
                r = {"name": "beam_gather", "mode": mode, "Q": nq,
                     "L": length, "D": d, "N": n,
                     "max_abs_err": float(err.max()), "digest": digest,
                     **timing(torch, [
                         lambda q=q, ids=ids: bg.beam_gather(
                             q, ids, corpus, mode=mode) for q, ids in sets]),
                     **plain_timing(torch, [
                         lambda q=q, ids=ids: plain(q, ids, corpus)
                         for q, ids in sets]),
                     "bound_ms": b_ms, "bound_us": b_ms * 1e3,
                     "bound_by": b_by}
                r["share"] = b_ms / r["ms"]
                rows.append(r)
                log(r)
            plain = ref.pair_gather_l2_ref if mode == "l2" \
                else ref.pair_gather_dot_ref
            # main-path shapes: the coarse prune (4096-node chunks of 52
            # kNN + 8 random candidates) and the stitch re-prune (1024-node
            # batches of 48 beam hits + the 32-slot row); the prune pads
            # invalid slots (empty row slots, duplicates, the node itself)
            # with row 0, so the stitch shape also runs with a third of its
            # slots on row 0
            for b, c, pad in ((4096, 60, 0.0), (1024, 80, 0.0),
                              (1024, 80, 0.3)):
                sets = []
                for _ in range(SETS):
                    ids = torch.randint(0, n, (b, c), generator=gen,
                                        device="cuda", dtype=torch.int32)
                    zero = torch.rand((b, c), generator=gen,
                                      device="cuda") < pad
                    sets.append(ids.masked_fill(zero, 0))
                ids = sets[0]
                got = pg.pair_gather(ids, corpus, mode=mode)
                want = plain(ids, corpus)
                torch.cuda.synchronize()
                err = (got - want).abs()
                nr = norms[ids.long()]
                tol = RTOL * want.abs() \
                    + ATOL_PER_NORM * nr[:, :, None] * nr[:, None, :]
                err_max = float(err.max())
                check(bool((err <= tol).all()),
                      f"pair_gather {mode} D={d} C={c}: max err "
                      f"{err_max} over tolerance")
                # exactly symmetric, and in l2 an exact-zero diagonal: each
                # entry is one fmaf chain over d, and fmaf(a, b, s) equals
                # fmaf(b, a, s)
                check(torch.equal(got, got.transpose(1, 2)),
                      f"pair_gather {mode} D={d} C={c}: not symmetric")
                if mode == "l2":
                    check(not bool(got.diagonal(dim1=1, dim2=2).any()),
                          f"pair_gather l2 D={d} C={c}: non-zero diagonal")
                digest = output_digest(got)
                del got, want, err, nr, tol
                # the C x C output is symmetric: the function needs only its
                # C(C+1)/2 distinct dot products (the diagonal gives the l2
                # norms), plus for l2 a 3-op epilogue on each; the output
                # is written whole
                uniq = int(torch.unique(ids).numel())
                pairs = b * c * (c + 1) // 2
                nbytes = uniq * d * 4 + b * c * 4 + b * c * c * 4
                flops = pairs * d * 2 + (pairs * 3 if mode == "l2" else 0)
                b_ms, b_by = bound(nbytes, flops)
                r = {"name": "pair_gather", "mode": mode, "B": b, "C": c,
                     "D": d, "N": n, "row0_frac": pad,
                     "max_abs_err": err_max, "digest": digest,
                     **timing(torch, [
                         lambda ids=ids: pg.pair_gather(ids, corpus, mode=mode)
                         for ids in sets]),
                     **plain_timing(torch, [lambda ids=ids: plain(ids, corpus)
                                            for ids in sets]),
                     "bound_ms": b_ms, "bound_us": b_ms * 1e3,
                     "bound_by": b_by}
                r["share"] = b_ms / r["ms"]
                rows.append(r)
                log(r)
                torch.cuda.empty_cache()
    return rows


def hamming_masked_bound(sets, w, nq):
    """B4's fused entry's bound, the mean over the input sets (ids, fresh):
    the unique rows of fresh slots (stale and PAD slots read none), the
    query words, and per slot 8 bytes of id, 1 of mask and 4 of output; W
    popcounts a fresh slot."""
    bs = [bound(int(ids[fresh].unique().numel()) * w * 4 + nq * w * 4
                + ids.numel() * 13, int(fresh.sum()) * w, POPC_PER_S)
          for ids, fresh in sets]
    return sum(b[0] for b in bs) / len(bs), bs[0][1]


def hamming_stage_rows(torch, lib, q_words, words, ids_sets, log):
    """B4's stage split at one (Q, L) (`scripts/hamming_stage_cycles.py`):
    the launch floor (an empty kernel), the ids' round trip, and (flat
    layout) the ids with the query words, each on the first kernel's
    (Q, L / 128) grid of 128 threads and on the shipped flat grid (its
    block size, a thread a pair)."""
    import hamming_stage_cycles as hsc

    layouts = [("grid2d", 0, 1, ("empty", "ids"))]
    block = hsc.shipped_block()
    if block:
        layouts.append(("flat", block, 1, ("empty", "ids", "ids_q")))
    out = torch.empty_like(ids_sets[0])
    nq, length = ids_sets[0].shape
    rows = []
    for layout, threads, w8, stages in layouts:
        for stage in stages:
            r = {"name": "beam_gather_hamming_stage", "stage": stage,
                 "layout": layout, "threads": threads or 128,
                 "w8_layout": w8, "Q": nq, "L": length,
                 "W": words.shape[1], "N": words.shape[0],
                 "ms": device_ms(torch, [
                     lambda ids=ids, stage=stage, threads=threads,
                     w8=w8: hsc.stage_call(
                         torch, lib, stage, threads, w8, q_words, ids,
                         words, out) for ids in ids_sets])}
            rows.append(r)
            log(r)
    return rows


def kernel_row(torch, log, name, err, fns, plains, b, libraries=None,
               **shape):
    """A kernel's row: its error, device time over the input sets ``fns``,
    its plain version's (``plains``), its bound ``b`` and, where one
    PyTorch call computes the same function, that call's time
    (``libraries``); logged and returned."""
    r = {"name": name, **shape, "max_abs_err": err,
         **timing(torch, fns), **plain_timing(torch, plains),
         "bound_ms": b[0], "bound_us": b[0] * 1e3, "bound_by": b[1],
         "library_ms": None}
    if libraries:
        r.update(timing(torch, libraries, prefix="library_"))
    r["share"] = b[0] / r["ms"]
    log(r)
    return r


def pq_adc_row(torch, lut_q, chunks, log, **extra):
    """B6 on ``lut_q`` (Q, m, k) against each of ``chunks`` ((N, m) code
    blocks of one shape, the input sets) and its plain version: both of its
    paths (the C entry takes the row-lane path when it is given no scratch)
    must give the plain version's bits.  library_ms is
    ``embedding_bag(codes + i * k, lut.T, mode="sum")`` over the flattened
    LUTs, the offsets and the transposed LUTs made outside the timed call;
    it adds in its own order (rtol 1e-5)."""
    import ctypes

    import torch.nn.functional as F
    from repro_torch.kernels import _launch, ref
    from repro_torch.kernels import pq_adc as adc_mod
    from repro_torch.kernels.pq_adc import pq_adc

    q_n, m, k = lut_q.shape
    cw = chunks[0]
    rows_n = cw.shape[0]
    before = dict(adc_mod.path_launches)
    got = pq_adc(lut_q, cw)
    path = next(p for p, v in adc_mod.path_launches.items()
                if v != before[p])
    want = ref.pq_adc_ref(lut_q, cw)
    rows_out = torch.empty_like(got)
    info = (ctypes.c_int * 1)()
    _launch.launch("pq_adc", adc_mod._fn(), lut_q.device, lut_q.data_ptr(),
                   cw.data_ptr(), rows_out.data_ptr(), None,
                   ctypes.addressof(info), q_n, rows_n, m, k, 1)
    offs = torch.arange(m, device="cuda") * k
    idxs = [c.long() + offs for c in chunks]
    lut_t = lut_q.reshape(q_n, m * k).T.contiguous()
    lib = F.embedding_bag(idxs[0], lut_t, mode="sum").T
    torch.cuda.synchronize()
    err = (got - want).abs()
    digest = output_digest(got)
    digests = {"plain": output_digest(want),
               "row_lanes": output_digest(rows_out)}
    check(info[0] == 0, "pq_adc without scratch took the query lanes")
    check(all(v == digest for v in digests.values()),
          f"pq_adc Q={q_n} N={rows_n} m={m}: digest {digest} vs {digests}")
    check(bool(((lib - want).abs() <= 1e-5 * want.abs()).all()),
          f"embedding_bag Q={q_n} N={rows_n} disagrees with pq_adc_ref")
    del got, want, lib, rows_out
    r = kernel_row(
        torch, log, "pq_adc", float(err.max()),
        [lambda c=c: pq_adc(lut_q, c) for c in chunks],
        [lambda c=c: ref.pq_adc_ref(lut_q, c) for c in chunks],
        bound(rows_n * m + q_n * m * k * 4 + q_n * rows_n * 4,
              q_n * rows_n * m),
        [lambda i=i: F.embedding_bag(i, lut_t, mode="sum") for i in idxs],
        Q=q_n, N=rows_n, m=m, k=k, path=path, digest=digest,
        digest_plain=digests["plain"],
        digest_row_lanes=digests["row_lanes"], **extra)
    del idxs, lut_t
    torch.cuda.empty_cache()
    return r


def hamming_row(torch, qw, chunks, log, **extra):
    """B7 on the query words ``qw`` (Q, W) against each of ``chunks`` ((N,
    W) word blocks of one shape, the input sets), exact against its plain
    version.  library_ms is ``cdist(p=0)`` (the count of differing
    coordinates) over the unpacked bits, exact in fp32 up to 2**24, the
    bits unpacked outside the timed call."""
    from repro_torch.core.bq import unpack_bits
    from repro_torch.kernels import ref
    from repro_torch.kernels.hamming import hamming

    q_n, w = qw.shape
    xw = chunks[0]
    rows_n = xw.shape[0]
    got = hamming(qw, xw)
    want = ref.hamming_ref(qw, xw)
    q_bits = unpack_bits(qw, w * 32).float()
    x_bits = [unpack_bits(c, w * 32).float() for c in chunks]
    lib = torch.cdist(q_bits, x_bits[0], p=0)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    check(err == 0, f"hamming Q={q_n} N={rows_n} W={w}: max err {err}")
    check(torch.equal(lib.int(), want),
          f"cdist(p=0) Q={q_n} N={rows_n} disagrees with hamming_ref")
    del got, want, lib
    r = kernel_row(
        torch, log, "hamming", err, [lambda c=c: hamming(qw, c) for c in chunks],
        [lambda c=c: ref.hamming_ref(qw, c) for c in chunks],
        bound(rows_n * w * 4 + q_n * w * 4 + q_n * rows_n * 4,
              q_n * rows_n * w, POPC_PER_S),
        [lambda x=x: torch.cdist(q_bits, x, p=0) for x in x_bits],
        Q=q_n, N=rows_n, W=w, **extra)
    del q_bits, x_bits
    torch.cuda.empty_cache()
    return r


def quant_kernel_checks(torch, codes, lut, words, q_words, log,
                        stage_lib=None):
    """The PQ and BQ kernels against their plain versions on the corpus's
    real codes: ``codes`` (N, m) uint8 PQ codes with ``lut`` (Q, m, k) the
    queries' LUTs, ``words`` (N, W) BQ words with ``q_words`` (Q, W).
    B4 has two entries, the TPU function (int32 ids) and the search step's
    fused form (int64 ids with PAD, a fresh mask, +inf on stale slots);
    with ``stage_lib`` (the library of `scripts/hamming_stage_cycles.py`)
    its stage split follows each L.

    library_ms, timed where one PyTorch call computes the same function:
    ``pq_adc`` is ``embedding_bag(codes + i * k, lut.T, mode="sum")`` over
    the flattened LUTs, and ``hamming`` is ``cdist(p=0)`` (the count of
    differing coordinates) over the unpacked bits; the index offsets, the
    transposed LUTs and the unpacked bits are made outside the timed call.
    The two gathers have none: the gather of code rows by ids is part of
    their function, and no one call both gathers and LUT-sums or counts.
    """
    from repro_torch.kernels import ref
    from repro_torch.kernels.beam_gather_adc import beam_gather_adc
    from repro_torch.kernels.beam_gather_hamming import (
        beam_gather_hamming, beam_gather_hamming_masked)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    n, m = codes.shape
    nq, _, k = lut.shape
    w = words.shape[1]
    rows = []

    def row(name, err, fns, plains, b, libraries=None, **shape):
        rows.append(kernel_row(torch, log, name, err, fns, plains, b,
                               libraries, **shape))

    for length in (1, 128, 256):
        sets = [torch.randint(0, n, (nq, length), generator=gen,
                              device="cuda", dtype=torch.int32)
                for _ in range(SETS)]
        ids = sets[0]
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
            [lambda ids=ids: beam_gather_adc(lut, ids, codes) for ids in sets],
            [lambda ids=ids: ref.beam_gather_adc_ref(lut, ids, codes)
             for ids in sets],
            bound(uniq * m + lut_bytes + nq * length * 8, nq * length * m),
            Q=nq, L=length, m=m, k=k, N=n, lut_bytes=lut_bytes)
        got = beam_gather_hamming(q_words, ids, words)
        want = ref.beam_gather_hamming_ref(q_words, ids, words)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        check(err == 0, f"beam_gather_hamming L={length}: max err {err}")
        # bytes: unique word rows, query words, ids, output; W popcounts
        row("beam_gather_hamming", err,
            [lambda ids=ids: beam_gather_hamming(q_words, ids, words)
             for ids in sets],
            [lambda ids=ids: ref.beam_gather_hamming_ref(q_words, ids, words)
             for ids in sets],
            bound(uniq * w * 4 + nq * w * 4 + nq * length * 8,
                  nq * length * w, POPC_PER_S),
            Q=nq, L=length, W=w, N=n)
        msets = []
        for ids_i in sets:
            ids64 = ids_i.long()
            fresh = torch.ones_like(ids_i, dtype=torch.bool)
            if length > 1:
                pad = torch.rand(ids_i.shape, generator=gen,
                                 device="cuda") < B4_PAD_SHARE
                fresh = (torch.rand(ids_i.shape, generator=gen,
                                    device="cuda") < B4_FRESH_SHARE) & ~pad
                ids64 = ids64.masked_fill(pad, -1)
            msets.append((ids64, fresh))
        ids64, fresh = msets[0]
        got = beam_gather_hamming_masked(q_words, ids64, fresh, words)
        want = ref.beam_gather_hamming_masked_ref(q_words, ids64, fresh,
                                                  words)
        torch.cuda.synchronize()
        # exact, the +inf of every stale slot included
        check(torch.equal(got, want),
              f"beam_gather_hamming_masked L={length}: differs from its "
              f"plain version")
        err = float((got[fresh] - want[fresh]).abs().max()) \
            if bool(fresh.any()) else 0.0
        row("beam_gather_hamming_masked", err,
            [lambda a=a, f=f: beam_gather_hamming_masked(q_words, a, f, words)
             for a, f in msets],
            [lambda a=a, f=f: ref.beam_gather_hamming_masked_ref(
                q_words, a, f, words) for a, f in msets],
            hamming_masked_bound(msets, w, nq), Q=nq, L=length, W=w, N=n,
            fresh_share=float(fresh.float().mean()),
            pad_share=float((ids64 < 0).float().mean()))
        if stage_lib is not None:
            rows.extend(hamming_stage_rows(torch, stage_lib, q_words, words,
                                           sets, log))

    # the flat route's shape (Q=1024 against one corpus chunk; the sets
    # are consecutive chunks, as the route scans them), a small batch
    # against the whole corpus, and the batcher's small batches against one
    # chunk (Q = 1 takes the row-lane path, 32 and 33 the query-lane path)
    for q_n, rows_n in ((nq, FLAT_CHUNK), (64, n), (1, FLAT_CHUNK),
                        (32, FLAT_CHUNK), (33, FLAT_CHUNK)):
        rows.append(pq_adc_row(torch, lut[:q_n], [
            codes[i * rows_n:(i + 1) * rows_n]
            for i in range(max(1, min(SETS, n // rows_n)))], log))
    for q_n, rows_n in ((nq, FLAT_CHUNK), (64, n)):
        rows.append(hamming_row(torch, q_words[:q_n], [
            words[i * rows_n:(i + 1) * rows_n]
            for i in range(max(1, min(SETS, n // rows_n)))], log))
    return rows


def bound_3xtf32(nbytes: float, mm_flops: float, other_flops: float = 0.0):
    """(ms, "bytes" | "operations"): B5's bound on the tensor cores, each
    fp32 product three TF32 products at the dense TF32 rate and any other
    flops at the fp32 rate, against the bytes over the memory rate."""
    tb = nbytes / HBM_BYTES_PER_S
    tf = 3 * mm_flops / TF32_FLOP_PER_S + other_flops / FP32_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def topk_vs_plain(torch, q, x, mode, k, got_d, got_i):
    """The fused entry against its plain version (plain distances, then
    topk_smallest), one 65,536-row block at a time: the k distances agree
    within RTOL + ATOL_PER_NORM |q||x|, and every returned row's plain
    distance lies within that tolerance of the plain k-th (the two sum in
    other orders, so rows that tie within rounding may trade places).
    Returns the largest distance error."""
    from repro_torch.core.flat import scan_topk
    from repro_torch.kernels import ref

    def plain(lo, hi):
        if mode == "l2":
            return ref.l2_distance_ref(q, x[lo:hi])
        d = ref.dot_distance_ref(q, x[lo:hi])
        return 1.0 + d if mode == "cosine" else d

    pd, pi = scan_topk(plain, x.shape[0], k, chunk=FLAT_CHUNK)
    xn = x.norm(dim=1)
    scale = ATOL_PER_NORM * q.norm(dim=1)[:, None]
    err = (got_d - pd).abs()
    check(bool((err <= RTOL * pd.abs() + scale * xn[pi.long()]).all()),
          f"l2_topk {mode} Q={q.shape[0]} N={x.shape[0]}: distances off "
          f"the plain version by {float(err.max())}")
    rows = x[got_i.reshape(-1)].view(*got_i.shape, -1)
    if mode == "l2":
        mine = ((rows - q[:, None, :]) ** 2).sum(-1)
    else:
        mine = -(rows * q[:, None, :]).sum(-1)
        mine = 1.0 + mine if mode == "cosine" else mine
    slack = RTOL * pd[:, -1:].abs() + scale * xn[got_i] + \
        RTOL * mine.abs()
    check(bool((mine <= pd[:, -1:] + slack).all()),
          f"l2_topk {mode} Q={q.shape[0]} N={x.shape[0]}: a returned row "
          f"lies outside the plain top-{k}")
    return float(err.max())


def fused_topk_row(torch, q, x, mode, k, got_d, got_i, sets, **extra):
    """B5's fused entry's row: ``got`` (its output on ``q``, ``x``) held to
    its plain version (`topk_vs_plain`), its device time over ``sets``
    ((q, x) input sets), and its bound held to 3xTF32 with the fp32 bound
    beside it.  library_ms is null: no one PyTorch call computes distances
    and their top-k."""
    from repro_torch.kernels.l2 import l2_topk

    nq, n, d = q.shape[0], x.shape[0], q.shape[1]
    err = topk_vs_plain(torch, q, x, mode, k, got_d, got_i)
    # inputs read once, the (Q, k) distances and ids written once
    nbytes = (nq + n) * d * 4 + nq * k * 12
    mm, other = 2 * nq * n * d, (2 * (nq + n) * d + 3 * nq * n
                                 if mode == "l2" else nq * n)
    b3, bf = bound_3xtf32(nbytes, mm, other), bound(nbytes, mm + other)
    t = timing(torch, [lambda q=q, x=x: l2_topk(q, x, k, mode=mode)
                       for q, x in sets])
    return {"name": "l2_topk", "mode": mode, "Q": nq, "N": n, "D": d,
            "k": k, "max_abs_err": err, **t, "bound_ms": b3[0],
            "bound_by": b3[1], "bound_fp32_ms": bf[0],
            "bound_held_to": "3xtf32", "share": b3[0] / t["ms"],
            "library_ms": None, **extra}


def captured_topk_row(torch, calls, log, **extra):
    """B5's fused entry where a phase ran it: ``calls`` holds the (queries,
    corpus, k, mode) of its launches there (`capture_topk`), the first of
    them the one it is held to and all of them its input sets.  The entry
    runs again on the first call's inputs, and its row (`fused_topk_row`,
    the plain version timed by `plain_timing`) is logged and returned."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.l2 import l2_topk

    q, x, k, mode = calls[0]
    check(all(c[1].shape == x.shape and c[2:] == (k, mode) for c in calls),
          f"l2_topk captures of {extra}: the calls differ in shape")
    got_d, got_i = l2_topk(q, x, k, mode=mode)
    r = fused_topk_row(torch, q, x, mode, k, got_d, got_i,
                       [(a, b) for a, b, _, _ in calls], **extra)
    r.update(plain_timing(torch, [lambda: ref.l2_topk_ref(q, x, k, mode)],
                          reps=5, warmup=1))
    log(r)
    return r


@contextlib.contextmanager
def capture_topk(sizes):
    """Within the block, keeps the inputs of every unmasked call to
    ``ops.l2_topk`` (the dispatch the exact scans call) whose query count
    is in ``sizes``: yields ``calls``, where ``calls[Q]`` lists (queries,
    corpus, k, mode).  The calls go on to the kernel as before and count as
    launches; callers on other threads are kept too."""
    from repro_torch.kernels import ops

    calls = {nq: [] for nq in sizes}
    orig = ops.l2_topk

    def keep(q, x, k, *, mode, mask=None, **kw):
        if mask is None and q.shape[0] in calls:
            calls[q.shape[0]].append((q, x, k, mode))
        return orig(q, x, k, mode=mode, mask=mask, **kw)

    ops.l2_topk = keep
    try:
        yield calls
    finally:
        ops.l2_topk = orig


def l2_distance_row(torch, mode, sets, log, **extra):
    """B5's matrix entry in ``mode`` over the input sets ``sets`` ((q, x)
    pairs of one shape): held to its plain version on the first at RTOL +
    ATOL_PER_NORM * |q| |x|, then timed, beside its plain version and one
    PyTorch call on the same inputs, TF32 off (cuBLAS SGEMM): ``addmm(out,
    q, x.T, beta=0, alpha=-1)`` for dot and ``cdist(q, x,
    compute_mode="use_mm_for_euclid_dist")`` for l2, whose square root is
    ignored.  bound_ms is the 3xTF32 bound the kernel is held to
    (`bound_3xtf32`), bound_fp32_ms the CUDA-core fp32 bound of the same
    work.  The row is logged and returned."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.l2 import l2_distance

    torch.backends.cuda.matmul.allow_tf32 = False
    q, x = sets[0]
    (nq, d), n = q.shape, x.shape[0]
    plain = ref.l2_distance_ref if mode == "l2" else ref.dot_distance_ref
    got = l2_distance(q, x, mode=mode)
    want = plain(q, x)
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = RTOL * want.abs() \
        + ATOL_PER_NORM * q.norm(dim=1)[:, None] * x.norm(dim=1)
    max_err = float(err.max())
    check(bool((err <= tol).all()),
          f"l2_distance {mode} Q={nq} N={n} D={d}: max err "
          f"{max_err} over tolerance")
    del got, want, err, tol
    out = torch.empty((nq, n), device="cuda")
    if mode == "dot":
        library = [lambda a=a, b=b: torch.addmm(out, a, b.T, beta=0,
                                                alpha=-1)
                   for a, b in sets]
    else:
        library = [lambda a=a, b=b: torch.cdist(
            a, b, compute_mode="use_mm_for_euclid_dist") for a, b in sets]
    # each input read once, the output written once; 2 flops per
    # product term, plus for l2 the norms and a 3-op epilogue
    nbytes = (nq + n) * d * 4 + nq * n * 4
    mm, other = 2 * nq * n * d, (2 * (nq + n) * d + 3 * nq * n
                                 if mode == "l2" else nq * n)
    b3, bf = bound_3xtf32(nbytes, mm, other), bound(nbytes, mm + other)
    t = timing(torch, [lambda a=a, b=b: l2_distance(a, b, mode=mode)
                       for a, b in sets])
    r = {"name": "l2_distance", "mode": mode, "Q": nq, "N": n,
         "D": d, "max_abs_err": max_err, **t,
         **plain_timing(torch, [lambda a=a, b=b: plain(a, b)
                                for a, b in sets]),
         "bound_ms": b3[0], "bound_us": b3[0] * 1e3,
         "bound_by": b3[1], "bound_fp32_ms": bf[0],
         "bound_held_to": "3xtf32", "share": b3[0] / t["ms"],
         **timing(torch, library, prefix="library_"), **extra}
    log(r)
    del out, library
    torch.cuda.empty_cache()
    return r


def l2_kernel_checks(torch, sift_cos, sift_raw, fm, signs, log):
    """B5's two entries against their plain versions.

    The matrix entry (``l2_distance``) at the shapes the exact scans gave
    it: Q = 1,024 against one 65,536-row chunk (cosine rows in dot mode,
    raw rows in l2), Q = 32 against it in dot mode (phase E's k = 1,000
    query, the matrix entry's one use on the main path), Fashion-MNIST's
    60,000 x 784 in both modes, the BQ delta scan's signs against a
    power-of-two delta pad, and the batcher's buckets (Q = 1, 7, 32)
    against the 16,960-row last chunk of 1M; at each,
    the fused entry (``l2_topk``, k = 10, cosine on the unit rows) must equal
    ``topk_smallest`` over the matrix entry's output bit for bit and agree
    with its plain version (`topk_vs_plain`).  Then the fused entry where
    the exact scans now run it: phase E's batch, Q = 1,024 against the
    whole 1M corpus (cosine, k = 10), and the batcher's Q = 1, 7, 32 against
    it, each beside the route it replaced (``route_ms``: the matrix entry
    over 65,536-row chunks, ``topk_smallest`` and ``merge_topk``, what
    ``flat_search`` ran before; a yardstick, not a library call), which it
    must equal bit for bit.

    bound_ms: the 3xTF32 bound the kernel is held to (`bound_3xtf32`),
    bound_fp32_ms the CUDA-core fp32 bound of the same work.  library_ms:
    the matrix entry's as `l2_distance_row` says (the port never calls
    either call); the fused entry has none: no one PyTorch call computes
    distances and their top-k."""
    from repro_torch.core.flat import scan_topk, topk_smallest
    from repro_torch.kernels import ref
    from repro_torch.kernels.l2 import l2_distance, l2_topk

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    rows = []

    def plain_topk(q, x, mode):
        return lambda: ref.l2_topk_ref(q, x, K, mode)

    def topk_row(q, x, mode, got_d, got_i, sets, **extra):
        rows.append(fused_topk_row(torch, q, x, mode, K, got_d, got_i, sets,
                                   **extra))
        return rows[-1]

    # (matrix mode, the fused entry's mode, corpus, Q, N): cosine is the
    # dot mode on the unit rows, plus one
    shapes = [("dot", "cosine", sift_cos, QUERY_BATCH, FLAT_CHUNK),
              ("dot", "cosine", sift_cos, 32, FLAT_CHUNK),
              ("l2", "l2", sift_raw, QUERY_BATCH, FLAT_CHUNK),
              ("l2", "l2", fm, QUERY_BATCH, fm.shape[0]),
              ("dot", "dot", fm, QUERY_BATCH, fm.shape[0]),
              ("dot", "dot", signs, QUERY_BATCH, 8192)]
    last = sift_cos.shape[0] % FLAT_CHUNK          # 16,960 at 1M
    shapes += [("dot", "cosine", sift_cos[-last:], nq, last)
               for nq in (1, 7, 32)]
    for mode, tmode, corpus, nq, n in shapes:
        # the sets: consecutive n-row chunks of the corpus where it holds
        # several (the flat route scans them in turn), each with its queries
        sets = []
        for i in range(max(1, min(SETS, corpus.shape[0] // n))):
            x = corpus[i * n:(i + 1) * n].contiguous()
            q = x[torch.randint(0, x.shape[0], (nq,), generator=gen,
                                device="cuda")]
            q = q + 0.01 * q.abs().mean() * torch.randn(
                q.shape, generator=gen, device="cuda")
            sets.append((q, x))
        rows.append(l2_distance_row(torch, mode, sets, log))
        q, x = sets[0]
        n, d = x.shape
        # the fused entry: topk_smallest over the matrix entry's output
        got = l2_distance(q, x, mode=mode)
        mat = 1.0 + got if tmode == "cosine" else got
        fd, fi = l2_topk(q, x, K, mode=tmode)
        wd, wi = topk_smallest(mat, K)
        check(torch.equal(fi, wi) and torch.equal(
            fd.view(torch.int32), wd.view(torch.int32)),
            f"l2_topk {tmode} Q={nq} N={n} D={d}: differs from topk_smallest "
            f"over the matrix entry")
        del got, mat, wd, wi
        r = topk_row(q, x, tmode, fd, fi, sets)
        r.update(plain_timing(torch, [plain_topk(a, b, tmode)
                                      for a, b in sets]))
        log(r)
        del x, q, fd, fi, sets
        torch.cuda.empty_cache()

    # the fused entry where the exact scans run it: the whole 1M corpus
    x = sift_cos
    n = x.shape[0]
    for nq in (QUERY_BATCH, 1, 7, 32):
        # the sets: queries only (the 512 MB corpus is cold in any case)
        qs = []
        for _ in range(SETS):
            q = x[torch.randint(0, n, (nq,), generator=gen, device="cuda")]
            qs.append(q + 0.01 * q.abs().mean() * torch.randn(
                q.shape, generator=gen, device="cuda"))
        q = qs[0]

        def route():
            return scan_topk(lambda lo, hi: 1.0 + l2_distance(
                q, x[lo:hi], mode="dot"), n, K, chunk=FLAT_CHUNK)

        fd, fi = l2_topk(q, x, K, mode="cosine")
        rd, ri = route()
        check(torch.equal(fi.int(), ri) and torch.equal(
            fd.view(torch.int32), rd.view(torch.int32)),
            f"l2_topk cosine Q={nq} N={n}: differs from the chunked route")
        r = topk_row(q, x, "cosine", fd, fi, [(a, x) for a in qs],
                     route_ms=time_ms(torch, route))
        r.update(plain_timing(torch, [plain_topk(q, x, "cosine")], reps=5,
                              warmup=1))
        log(r)
        del q, qs, fd, fi, rd, ri
        torch.cuda.empty_cache()
    return rows


def small_topk_sweep(torch, corpora, log):
    """B5's fused entry against the matrix route (one matrix entry launch
    and ``topk_smallest``) on the small corpora of SMALL_SWEEP, where
    ``flat_search`` takes the route past the fused entry's fast k
    (``MATRIX_MAX_N``, ``fused_fast_k``): the two must agree bit for bit,
    and each row gives both device times and the one ``dispatch`` picks.
    ``corpora``: name -> an (N', D) tensor whose first N rows are the
    corpus and the queries are perturbed rows of it."""
    from repro_torch.core.flat import fused_fast_k, takes_fused
    from repro_torch.kernels.l2 import fast_k, l2_distance, l2_topk
    from repro_torch.kernels.ref import topk_smallest

    for nq in (1, 32, 33, 1024):
        check(fused_fast_k(nq) == fast_k(nq),
              f"fused_fast_k({nq}) = {fused_fast_k(nq)}, the kernel's "
              f"{fast_k(nq)}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    for nq, n, mode, src, ks in SMALL_SWEEP:
        x = corpora[src][:n].contiguous()
        sets = []
        for _ in range(SETS):
            q = x[torch.randint(0, n, (nq,), generator=gen, device="cuda")]
            sets.append(q + 0.01 * q.abs().mean() * torch.randn(
                q.shape, generator=gen, device="cuda"))
        mat = "l2" if mode == "l2" else "dot"
        for k in ks:
            def route(q):
                d = l2_distance(q, x, mode=mat)
                return topk_smallest(1.0 + d if mode == "cosine" else d, k)

            fd, fi = l2_topk(sets[0], x, k, mode=mode)
            rd, ri = route(sets[0])
            check(torch.equal(fi, ri) and torch.equal(
                fd.view(torch.int32), rd.view(torch.int32)),
                f"l2_topk {mode} Q={nq} N={n} k={k}: differs from the "
                f"matrix route")
            del fd, fi, rd, ri
            log({"topk_sweep": "l2_topk vs matrix route", "Q": nq, "N": n,
                 "D": x.shape[1], "mode": mode, "k": k,
                 **timing(torch, [lambda q=q: l2_topk(q, x, k, mode=mode)
                                  for q in sets]),
                 **timing(torch, [lambda q=q: route(q) for q in sets],
                          prefix="route_"),
                 "dispatch": "fused" if takes_fused(mode, nq, n, k)
                 else "route"})
        torch.cuda.empty_cache()


def topk_k_sweep(torch, sift_cos, sift_raw, log):
    """The fused entry against the chunked route it replaced (the matrix
    entry over 65,536-row chunks, ``topk_smallest``, ``merge_topk``) over
    the whole 1M corpus (cosine) at phase E's batch (Q = 1,024) and the
    batcher's largest bucket (Q = 32), for each k in TOPK_SWEEP_K: on
    either side of the k where a block's lists leave shared memory for
    ``cand`` in global memory (16 / 17 at Q > 32, 64 / 65 at Q <= 32) and
    up to the fused entry's limit.  Each pair must agree bit for bit;
    ``flat_search`` takes the one ``dispatch`` names (``FUSED_MAX_K``).
    Then the exact cosine batch's transient device memory (peak minus what
    was allocated before it) through ``flat_search``, with the corpus
    normalized in the call and with the engine's cached unit rows."""
    from repro_torch.core.flat import FUSED_MAX_K, flat_search, scan_topk
    from repro_torch.kernels.l2 import l2_distance, l2_topk

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    x = sift_cos
    n = x.shape[0]
    for nq in (QUERY_BATCH, 32):
        q = x[torch.randint(0, n, (nq,), generator=gen, device="cuda")]
        q = q + 0.01 * q.abs().mean() * torch.randn(
            q.shape, generator=gen, device="cuda")
        for k in TOPK_SWEEP_K:
            def route():
                return scan_topk(lambda lo, hi: 1.0 + l2_distance(
                    q, x[lo:hi], mode="dot"), n, k, chunk=FLAT_CHUNK)

            fd, fi = l2_topk(q, x, k, mode="cosine")
            rd, ri = route()
            check(torch.equal(fi.int(), ri) and torch.equal(
                fd.view(torch.int32), rd.view(torch.int32)),
                f"l2_topk cosine Q={nq} N={n} k={k}: differs from the "
                f"chunked route")
            del fd, fi, rd, ri
            log({"topk_sweep": "l2_topk vs route", "Q": nq, "N": n, "k": k,
                 "ms": time_ms(torch, lambda: l2_topk(q, x, k, mode="cosine"),
                               reps=5, warmup=1),
                 "route_ms": time_ms(torch, route, reps=5, warmup=1),
                 "dispatch": "fused" if k <= FUSED_MAX_K else "route"})
        torch.cuda.empty_cache()

    q = sift_raw[:QUERY_BATCH]
    out = {"memory": "exact cosine batch, flat_search", "Q": QUERY_BATCH,
           "N": n, "k": K}
    for name, corpus, unit in (("normalized_per_call_gb", sift_raw, False),
                               ("unit_corpus_gb", sift_cos, True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        flat_search(q, corpus, K, metric="cosine", unit_corpus=unit)
        torch.cuda.synchronize()
        out[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(out)


# ---------------------------------------------------------------------------
# phases A-D: four collections through the engine
# ---------------------------------------------------------------------------

def exact_topk(torch, corpus, queries, metric, k, mask=None):
    """Exact top-k by plain torch.matmul on the card (the recall yardstick:
    the kernels' plain versions, never a kernel under test), optionally
    over the rows a mask keeps."""
    from repro_torch.core.distances import normalize
    from repro_torch.kernels import ref

    def plain(a, b):
        if metric == "l2":
            return ref.l2_distance_ref(a, b)
        d = ref.dot_distance_ref(a, b)
        return 1.0 + d if metric == "cosine" else d

    def prep(t):
        return normalize(t) if metric == "cosine" else t

    out = []
    corpus_dev = prep(torch.as_tensor(corpus, device="cuda"))
    for lo in range(0, len(queries), QUERY_BATCH):
        q = prep(torch.as_tensor(queries[lo: lo + QUERY_BATCH],
                                 device="cuda"))
        d = plain(q, corpus_dev)
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


def fused_step_row(torch, eng, queries, log):
    """B4's fused entry where phase D runs it.  One 1,024-query batch at
    ef 64 runs under ``torch.profiler`` after a warm-up batch, with the
    entry's inputs kept at every call: the kernel's device ms in that
    batch (``in_path_ms``, its launches beside it), the calls a batch and
    the share of fresh slots over the layer-0 steps.  Then the entry is
    held against its plain version on four of the batch's steps (at 20, 40,
    60 and 80 % of them), exactly, and timed on them as input sets, with
    its bound from those steps' own fresh rows (`hamming_masked_bound`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.beam_gather_hamming import \
        beam_gather_hamming_masked

    fused = ops.beam_gather_hamming_masked
    calls = []

    def keep(qc, ids, fresh, codes, **kw):
        calls.append((qc, ids, fresh, codes))
        return fused(qc, ids, fresh, codes, **kw)

    batch = queries[:QUERY_BATCH]
    ops.beam_gather_hamming_masked = keep
    try:
        eng.search(batch, K, ef=EF, expansion_width=WIDTH)
        torch.cuda.synchronize()
        calls.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.search(batch, K, ef=EF, expansion_width=WIDTH)
            torch.cuda.synchronize()
    finally:
        ops.beam_gather_hamming_masked = fused
    kern = [e.duration_ns() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and "beam_gather_hamming_kernel" in e.name()]
    steps = [c for c in calls if c[1].shape[1] > 1]
    check(len(steps) == len(calls) - 1,
          f"D: {len(calls)} fused calls a batch, {len(steps)} of them steps")
    picked = [steps[int(len(steps) * f)] for f in (0.2, 0.4, 0.6, 0.8)]
    qc, _, _, codes = picked[0]
    errs = []
    for _, ids, fresh, _ in picked:
        got = beam_gather_hamming_masked(qc, ids, fresh, codes)
        want = ref.beam_gather_hamming_masked_ref(qc, ids, fresh, codes)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              "D: the fused entry differs from its plain version on a "
              "search step")
        errs.append(float((got[fresh] - want[fresh]).abs().max())
                    if bool(fresh.any()) else 0.0)
    nq, length = picked[0][1].shape
    b = hamming_masked_bound([(i, f) for _, i, f, _ in picked],
                             codes.shape[1], nq)
    r = {"name": "beam_gather_hamming_masked", "inputs": "D search steps",
         "Q": nq, "L": length, "W": codes.shape[1], "N": codes.shape[0],
         "max_abs_err": max(errs),
         **timing(torch, [lambda i=i, f=f: beam_gather_hamming_masked(
             qc, i, f, codes) for _, i, f, _ in picked]),
         **plain_timing(torch, [
             lambda i=i, f=f: ref.beam_gather_hamming_masked_ref(
                 qc, i, f, codes) for _, i, f, _ in picked]),
         "bound_ms": b[0], "bound_us": b[0] * 1e3, "bound_by": b[1],
         "library_ms": None,
         "fresh_share": sum(float(f.float().mean()) for _, _, f, _ in picked)
         / len(picked),
         "fresh_share_batch": sum(int(c[2].sum()) for c in steps)
         / sum(c[2].numel() for c in steps),
         "calls_batch": len(calls), "steps_batch": len(steps),
         "in_path_ms": sum(kern) / 1e6, "in_path_launches": len(kern)}
    r["share"] = b[0] / r["ms"]
    log(r)
    return r


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
    if quant == "bq":
        # after the launch count: these launches are measurements
        res["fused_step"] = fused_step_row(torch, eng, queries, log)
    log({"phase_result": res})
    del eng
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase E: the public API on the card
# ---------------------------------------------------------------------------

def exact_payloads(n, seed):
    """Payloads of the exact collection, made from the seed: a category of
    8, a price, a flag and a 4-word title from a 5,000-word vocabulary."""
    import numpy as np
    rng = np.random.RandomState(seed)
    cat = rng.randint(0, N_CATEGORIES, n)
    price = rng.randint(0, 10_000, n) / 100.0
    stock = rng.random_sample(n) < 0.7
    words = rng.randint(0, TITLE_VOCAB, (n, 4))
    payloads = [{"category": f"cat-{c}", "price": float(p),
                 "in_stock": bool(b), "title": " ".join(f"t{w}" for w in ws)}
                for c, p, b, ws in zip(cat, price, stock, words)]
    return payloads, cat


def hit_rows(hits):
    """Rows of the corpus (ids "<row>") of a batch of hit lists, -1 where a
    list is short."""
    import numpy as np
    out = np.full((len(hits), K), -1, dtype=np.int64)
    for i, hs in enumerate(hits):
        for j, h in enumerate(hs[:K]):
            out[i, j] = int(h.id)
    return out


def query_batches(col, queries, **knobs):
    """All queries in 2-D batches of QUERY_BATCH through the fluent API;
    returns (rows, seconds)."""
    import numpy as np
    out = []
    t0 = time.perf_counter()
    for lo in range(0, len(queries), QUERY_BATCH):
        q = col.query(queries[lo: lo + QUERY_BATCH]).top_k(K)
        if "ef" in knobs:
            q = q.ef(knobs["ef"])
        out.append(hit_rows(q.run()))
    return np.concatenate(out), time.perf_counter() - t0


def single_queries(col, queries):
    """Each query alone from SINGLE_THREADS threads (the batcher path,
    `http_load.singles`); returns (rows, per-query seconds, errors)."""
    import http_load
    hits, lat, errors = http_load.singles(col, queries, K, SINGLE_THREADS)
    return hit_rows(hits), lat, errors


def run_api(torch, corpus, queries, gt, new_rows, phase_a, counters, log):
    """Phase E: the exact and the default collection through
    ``repro_torch.api.Database`` on the card, then save and load."""
    import numpy as np

    from repro_torch.api import (BoolField, Database, KeywordField,
                                 NumericField, TextField, VectorField)
    from repro_torch.core import recall_at_k

    n = len(corpus)
    ids = [str(i) for i in range(n)]
    res = {"phase": "E", "n": n, "dim": int(corpus.shape[1])}
    t0 = time.perf_counter()
    payloads, cat = exact_payloads(n, seed=3)
    res["payloads_s"] = time.perf_counter() - t0
    counters.reset()
    db = Database()                                   # the card
    exact = db.create_collection(
        name="exact", vector=VectorField(dim=128, metric="cosine",
                                         index="flat"),
        fields=(KeywordField("category"), NumericField("price"),
                BoolField("in_stock"), TextField("title")))
    t0 = time.perf_counter()
    for lo in range(0, n, UPSERT_BATCH):
        exact.upsert(ids[lo: lo + UPSERT_BATCH], corpus[lo: lo + UPSERT_BATCH],
                     payloads[lo: lo + UPSERT_BATCH])
    res["exact_upsert_rows_per_s"] = n / (time.perf_counter() - t0)
    del payloads
    log({"api": "exact upsert", **res})

    # batched: every 2-D batch scans the 1M rows in 65,536-row chunks
    rows, secs = query_batches(exact, queries)
    torch.cuda.synchronize()
    res["exact_qps"] = len(queries) / secs
    res["exact_recall_at_10"] = recall_at_k(rows, gt)
    check(res["exact_recall_at_10"] >= EXACT_RECALL_FLOOR,
          f"E: exact batched recall {res['exact_recall_at_10']}")
    # one more batch: the device memory it takes past what stays resident
    # (by now the collection's unit corpus, cached by the engine)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    exact.query(queries[:QUERY_BATCH]).top_k(K).run()
    torch.cuda.synchronize()
    res["exact_resident_gb"] = base / 2**30
    res["exact_batch_transient_gb"] = \
        (torch.cuda.max_memory_allocated() - base) / 2**30

    # single vectors from 32 threads, coalesced by the batcher
    single = queries[:SINGLE_QUERIES]
    before = exact.stats()
    t0 = time.perf_counter()
    rows, lat, errors = single_queries(exact, single)
    secs = time.perf_counter() - t0
    check(not errors, f"E: single-vector queries failed: {errors[:3]}")
    after = exact.stats()
    batches = after["serving_batches_served"] - before["serving_batches_served"]
    served = after["serving_requests_served"] - before["serving_requests_served"]
    res["single_qps"] = len(single) / secs
    res["single_p50_ms"] = float(np.percentile(lat, 50) * 1e3)
    res["single_p99_ms"] = float(np.percentile(lat, 99) * 1e3)
    res["single_mean_batch"] = served / max(batches, 1)
    res["single_recall_at_10"] = recall_at_k(rows, gt[:SINGLE_QUERIES])
    check(served == len(single), f"E: batcher served {served} requests")
    check(res["single_mean_batch"] > 1, "E: the batcher never coalesced")
    check(res["single_recall_at_10"] >= EXACT_RECALL_FLOOR,
          f"E: single-vector recall {res['single_recall_at_10']}")

    # a rerank-sized query, k = 1,000 (past B5's fused entry's 256: the
    # matrix entry and the chunked scan): its first 10 hits are the k = 10
    # answer, which the fused entry gave
    wide_q = queries[:32]
    wide = exact.query(wide_q).top_k(1000).run()
    narrow = exact.query(wide_q).top_k(K).run()
    check(all(len(w) == 1000 for w in wide) and
          [[h.id for h in w[:K]] for w in wide] ==
          [[h.id for h in nw] for nw in narrow],
          "E: the k = 1,000 query's first 10 hits differ from k = 10's")

    # a metadata filter (1 in 8): every hit matches, exact against a
    # masked top-k
    q = queries[:QUERY_BATCH]
    hits = exact.query(q).filter(category="cat-3").top_k(K).run()
    check(all(h.payload["category"] == "cat-3" for hs in hits for h in hs),
          "E: a filtered hit does not match the filter")
    mask_gt = exact_topk(torch, corpus, q, "cosine", K, mask=(cat == 3))
    res["filter_recall_at_10"] = recall_at_k(hit_rows(hits), mask_gt)
    check(res["filter_recall_at_10"] >= EXACT_RECALL_FLOOR,
          f"E: filtered recall {res['filter_recall_at_10']}")
    log({"api": "exact queries", **res})

    # deletes and replacing upserts
    rng = np.random.RandomState(11)
    picked = rng.choice(n, 2_000, replace=False)
    gone, replaced = picked[:1_000], picked[1_000:]
    check(exact.delete([ids[i] for i in gone]) == 1_000, "E: delete count")
    exact.upsert([ids[i] for i in replaced], new_rows[:1_000],
                 [{"category": "cat-0", "title": "replaced row"}] * 1_000)
    check(exact.count() == n - 1_000 and len(exact) == n - 1_000,
          f"E: count {exact.count()} after 1,000 deletes")
    gone_set = {ids[i] for i in gone}
    hits = exact.query(corpus[gone]).top_k(K).run()
    check(not any(h.id in gone_set for hs in hits for h in hs),
          "E: a deleted id came back")
    hits = exact.query(new_rows[:1_000]).top_k(1).run()
    res["replaced_rank1"] = float(np.mean(
        [hs[0].id == ids[i] for hs, i in zip(hits, replaced)]))
    check(res["replaced_rank1"] == 1.0,
          f"E: replaced ids at rank 1: {res['replaced_rank1']}")

    # hybrid: a BM25 leg over the titles fused with the vector leg by RRF
    plan = exact.query(corpus[replaced[0]]).text("t17 t4242").top_k(K)
    hits = plan.run()
    check(len(hits) > 0 and all(h.id not in gone_set for h in hits),
          "E: hybrid query returned no hits or a deleted id")
    res["hybrid_hits"] = len(hits)
    log({"api": "exact writes", **res})

    # the default collection: cosine, HNSW, bulk builder
    default = db.create_collection(name="default",
                                   vector=VectorField(dim=128))
    t0 = time.perf_counter()
    for lo in range(0, n, UPSERT_BATCH):
        default.upsert(ids[lo: lo + UPSERT_BATCH],
                       corpus[lo: lo + UPSERT_BATCH])
    res["default_upsert_rows_per_s"] = n / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    default.query(queries[:1]).top_k(K).run()         # builds
    torch.cuda.synchronize()
    res["default_build_s"] = time.perf_counter() - t0
    for ef in (64, 256):
        rows, secs = query_batches(default, queries, ef=ef)
        rec = recall_at_k(rows, gt)
        res[f"default_ef{ef}_recall_at_10"] = rec
        res[f"default_ef{ef}_qps"] = len(queries) / secs
        res[f"default_ef{ef}_equals_phase_a"] = \
            rec == phase_a["ef_sweep"][ef]["recall_at_10"]
        check(rec >= RECALL_FLOORS["A"][ef],
              f"E: default recall@10 {rec} at ef={ef} under "
              f"{RECALL_FLOORS['A'][ef]}")
    new_ids = [f"new-{i}" for i in range(len(new_rows))]
    default.upsert(new_ids, new_rows)
    st = default.stats()
    check(st["delta_rows"] == len(new_rows) and st["seals"] == 0,
          "E: new ids did not stay in the delta segment")
    top = []
    for lo in range(0, len(new_rows), QUERY_BATCH):
        top += [hs[0].id for hs in default.query(
            new_rows[lo: lo + QUERY_BATCH]).top_k(K).run()]
    res["default_delta_rank1"] = float(np.mean(
        [a == b for a, b in zip(top, new_ids)]))
    check(res["default_delta_rank1"] == 1.0,
          f"E: delta rank-1 rate {res['default_delta_rank1']}")
    log({"api": "default", **res})

    # persistence: both collections answer the same after save and load
    probe = queries[:QUERY_BATCH]

    def answers(database):
        return {name: [[(h.id, h.score) for h in hs] for hs in
                       database[name].query(probe).top_k(K).run()]
                for name in ("exact", "default")}

    want = answers(db)
    tmp = tempfile.mkdtemp(prefix="quantixar-smoke-")
    try:
        t0 = time.perf_counter()
        db.save(tmp)
        res["save_s"] = time.perf_counter() - t0
        db.close()
        del db, exact, default
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        loaded = Database.load(tmp)                   # the card
        res["load_s"] = time.perf_counter() - t0
        got = answers(loaded)
        res["checkpoint_gb"] = sum(
            os.path.getsize(os.path.join(r, f))
            for r, _, fs in os.walk(tmp) for f in fs) / 2**30
        loaded.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name in want:
        check(got[name] == want[name],
              f"E: {name} answers differ after save and load")
    res["launches"] = counters.read()
    for kname in PHASE_KERNELS["E"]:
        check(res["launches"][kname] > 0,
              f"E: kernel {kname} never launched")
    log({"phase_result": res})
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase G: IVF on the card
# ---------------------------------------------------------------------------

def ivf_lists_rows(torch, eng, queries, log):
    """B1's list-major entry where phase G runs it, and B1's gather entry
    on the same candidates, which it replaced (the yardstick).  SETS
    batches of QUERY_BATCH queries run with the entry's inputs kept
    (queries, the (Q, nprobe) probes, the lists, their live lengths, the
    prepped corpus).  On the first batch the entry must equal B1's gather
    entry over the candidate block lists[probe] (PAD clamped to row 0, as
    B1 reads it) bit for bit on every live slot and be +inf on every PAD
    slot; on its first IVF_PLAIN_Q queries both are held to their plain
    versions.  Both are timed at their device time over the batches as
    input sets, in this call.  Each row's bound_ms counts what its own
    function needs: B1's the unique rows a batch touches, its ids and
    queries read once and its output written once, or 3 operations a
    candidate element, PAD slots included; the entry's the same rows,
    queries and output with the probe and the lists (and their lengths)
    in place of the ids, or 3 operations a live slot's element only, for
    it computes nothing on PAD.  The entry's row also carries B1's bound
    at this shape (bound_b1_ms, share_b1), the yardstick both rows meet.
    Returns (the entry's row, B1's row)."""
    from repro_torch.core.ivf import PAD
    from repro_torch.kernels import beam_gather as bg
    from repro_torch.kernels import ops, ref

    orig = ops.beam_gather_lists_distances
    calls = []

    def keep(q, probe, lists, list_len, corpus, **kw):
        calls.append((q, probe, lists, list_len, corpus))
        return orig(q, probe, lists, list_len, corpus, **kw)

    ops.beam_gather_lists_distances = keep
    try:
        for lo in range(0, SETS * QUERY_BATCH, QUERY_BATCH):
            eng.search(queries[lo: lo + QUERY_BATCH], K)
    finally:
        ops.beam_gather_lists_distances = orig
    torch.cuda.synchronize()
    check(len(calls) == SETS,
          f"G: {len(calls)} beam_gather_lists calls for {SETS} batches")
    _, _, lists, list_len, corpus = calls[0]
    sets = [(q.float().contiguous(), p.to(torch.int32).contiguous())
            for q, p, *_ in calls]
    # the candidate block the card path no longer builds, for B1
    cands = [lists[p.long()].reshape(p.shape[0], -1) for _, p in sets]
    b1_sets = [(q, c.clamp_min(0).contiguous()) for (q, _), c in
               zip(sets, cands)]
    q, probe = sets[0]
    nq, nprobe = probe.shape
    nlist, m = lists.shape
    length, d = nprobe * m, corpus.shape[1]
    got = bg.beam_gather_lists(q, probe, lists, list_len, corpus)
    b1 = bg.beam_gather(q, b1_sets[0][1], corpus, mode="l2")
    torch.cuda.synchronize()
    live = cands[0] != PAD
    check(torch.equal(got[live].view(torch.int32), b1[live].view(torch.int32)),
          f"G: beam_gather_lists differs from beam_gather on "
          f"{int((got[live] != b1[live]).sum())} live slots")
    check(bool(torch.isinf(got[~live]).all()),
          "G: beam_gather_lists is finite on a PAD slot")
    digest = output_digest(got)
    del b1
    # both held to their plain versions on the first IVF_PLAIN_Q queries
    sub_q, sub_p = q[:IVF_PLAIN_Q].contiguous(), probe[:IVF_PLAIN_Q].contiguous()
    sub_ids = b1_sets[0][1][:IVF_PLAIN_Q].contiguous()
    sub_live = live[:IVF_PLAIN_Q]
    norms = corpus.norm(dim=1)[sub_ids.long()]
    atol = ATOL_PER_NORM * sub_q.norm(dim=1)[:, None] * norms
    want = ref.beam_gather_lists_ref(sub_q, sub_p, lists, list_len, corpus)
    err = (got[:IVF_PLAIN_Q] - want)[sub_live].abs()
    check(bool((err <= RTOL * want[sub_live].abs() + atol[sub_live]).all())
          and torch.equal(torch.isinf(got[:IVF_PLAIN_Q]), torch.isinf(want)),
          f"G: beam_gather_lists at IVF's shape: max err {float(err.max())}")
    lists_err = float(err.max())
    del want, err
    b1_sub = bg.beam_gather(sub_q, sub_ids, corpus, mode="l2")
    want = ref.beam_gather_l2_ref(sub_q, sub_ids, corpus)
    torch.cuda.synchronize()
    err = (b1_sub - want).abs()
    check(bool((err <= RTOL * want.abs() + atol).all()),
          f"G: beam_gather at IVF's shape: max err {float(err.max())}")
    b1_err = float(err.max())
    del want, err, b1_sub, norms, atol, got

    # the schedule: tiles a batch and the rows they read
    tq = bg.tile_q(d)
    lst, _, count = bg.tile_of_block(
        *bg.list_tiles(probe, nlist, tq)[1:], tq,
        bg.list_blocks(probe.numel(), nlist, tq))
    tiles = lst < nlist
    tile_rows = int(list_len.long()[lst[tiles]].sum())
    pad_share = float((~live).float().mean())
    n_live = sum(int((c != PAD).sum()) for c in cands) / len(cands)
    uniq = sum(int(torch.unique(c.clamp_min(0)).numel()) for c in cands) \
        / len(cands)
    del cands, live
    nbytes = uniq * d * 4 + nq * d * 4 + nq * length * 4 + nq * length * 4
    b_ms, b_by = bound(nbytes, nq * length * d * 3)
    live_ms, live_by = bound(uniq * d * 4 + nq * d * 4 + nq * nprobe * 4
                             + nlist * (m + 1) * 4 + nq * length * 4,
                             n_live * d * 3)
    shape = {"inputs": "G search batches", "mode": "l2", "Q": nq,
             "L": length, "P": nprobe, "M": m, "nlist": nlist, "D": d,
             "N": corpus.shape[0], "pad_share": pad_share,
             "unique_rows": uniq, "live_slots": n_live,
             "checked_Q": IVF_PLAIN_Q, "library_ms": None}
    t_lists = timing(torch, [lambda q=q, p=p: bg.beam_gather_lists(
        q, p, lists, list_len, corpus) for q, p in sets])
    t_b1 = timing(torch, [lambda q=q, c=c: bg.beam_gather(
        q, c, corpus, mode="l2") for q, c in b1_sets])
    lists_row = {
        "name": "beam_gather_lists", **shape, "bound_ms": live_ms,
        "bound_us": live_ms * 1e3, "bound_by": live_by,
        "bound_b1_ms": b_ms, "max_abs_err": lists_err, "digest": digest, "bit_equal_to_beam_gather": True, **t_lists,
        "b1_ms": t_b1["ms"], "b1_call_ms": t_b1["call_ms"],
        "plain_ms": time_ms(torch, lambda: ref.beam_gather_lists_ref(
            sub_q, sub_p, lists, list_len, corpus), reps=5, warmup=1),
        "plain_timer": "call", "plain_Q": IVF_PLAIN_Q,
        "tile_q": tq, "tiles": int(tiles.sum()),
        "tile_fill": float(count[tiles].float().mean()) / tq,
        "row_bytes_read": tile_rows * d * 4}
    lists_row["share"] = live_ms / lists_row["ms"]
    lists_row["share_b1"] = b_ms / lists_row["ms"]
    log(lists_row)
    b1_row = {
        "name": "beam_gather", **shape, "bound_ms": b_ms,
        "bound_us": b_ms * 1e3, "bound_by": b_by, "max_abs_err": b1_err,
        **t_b1,
        # the plain version gathers (64, C, D) rows, 1.5 GB, and keeps
        # two temporaries as large: timed per call, never in a graph
        "plain_ms": time_ms(torch, lambda: ref.beam_gather_l2_ref(
            sub_q, sub_ids, corpus), reps=5, warmup=1),
        "plain_timer": "call", "plain_Q": IVF_PLAIN_Q,
        "row_bytes_read": nq * length * d * 4}
    b1_row["share"] = b_ms / b1_row["ms"]
    log(b1_row)
    del calls, sets, b1_sets
    torch.cuda.empty_cache()
    return lists_row, b1_row


@contextlib.contextmanager
def capture_probes():
    """Within the block, keeps the (queries, centroids, k, metric) of every
    coarse probe ``_ivf_search`` runs (its ``flat_search`` call); yields
    the list.  The calls go on as before."""
    from repro_torch.core import ivf as ivf_mod

    calls = []
    orig = ivf_mod.flat_search

    def keep(q, x, k, metric="cosine", **kw):
        calls.append((q, x, k, metric))
        return orig(q, x, k, metric=metric, **kw)

    ivf_mod.flat_search = keep
    try:
        yield calls
    finally:
        ivf_mod.flat_search = orig


def ivf_probe_row(torch, probes, log):
    """G's coarse probe, Q = 1,024 prepped queries x the 1,024 centroids,
    l2, k = nprobe = 32: the route ``flat_search`` takes there (B5's matrix
    entry and ``topk_smallest``, `takes_fused` False) against B5's fused
    entry on the same inputs, which it must equal bit for bit; the fused
    entry's row (`captured_topk_row`: held to its plain version, timed)
    with the route's device and call times beside it (``route_ms``)."""
    from repro_torch.core.flat import flat_search, takes_fused
    from repro_torch.kernels.l2 import l2_topk

    q, x, k, metric = probes[0]
    check(metric == "l2" and not takes_fused(metric, q.shape[0],
                                             x.shape[0], k),
          f"G: the coarse probe takes the fused entry ({q.shape}, k {k})")
    rd, ri = flat_search(q, x, k, metric=metric)
    fd, fi = l2_topk(q, x, k, mode=metric)
    check(torch.equal(ri, fi.int()) and torch.equal(
        rd.view(torch.int32), fd.view(torch.int32)),
        "G: the probe's route differs from the fused entry")
    r = captured_topk_row(torch, probes, log, inputs="G coarse probe",
                          dispatch="route")
    r.update(timing(torch, [lambda a=a, b=b: flat_search(a, b, k, metric=metric)
                            for a, b, _, _ in probes], prefix="route_"))
    log(r)
    return r


def run_ivf(torch, corpus, queries, gt, new_rows, counters, log):
    """Phase G: an IVF engine over phase A's data on the card."""
    import numpy as np

    from repro_torch.core import (EngineConfig, IVFConfig, QuantixarEngine,
                                  recall_at_k)

    res = {"phase": "G", "n": int(len(corpus)), "dim": int(corpus.shape[1]),
           "metric": "cosine", "index": "ivf", "nlist": IVF_NLIST,
           "nprobe": IVF_NPROBE}
    cfg = EngineConfig(dim=corpus.shape[1], metric="cosine", index="ivf",
                       ivf=IVFConfig(nlist=IVF_NLIST, nprobe=IVF_NPROBE))
    eng = QuantixarEngine(cfg)
    eng.add(corpus)
    marks = []

    def progress(phase, done, total):
        if done == total:
            torch.cuda.synchronize()
            marks.append((phase, time.perf_counter()))

    counters.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.build(progress=progress)
    torch.cuda.synchronize()
    res["build_s"] = time.perf_counter() - t0
    res["build_peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    prev, phases = t0, {}
    for phase, t in marks:
        phases[phase] = t - prev
        prev = t
    res["build_phase_s"] = phases
    st = eng.stats()
    for key in ("ivf_lists", "ivf_mean_list", "ivf_max_list"):
        res[key] = st[key]
    res["max_list"] = int(eng._ivf.lists.shape[1])
    res["candidates_per_query"] = IVF_NPROBE * res["max_list"]
    res["full_lists"] = int((eng._ivf.list_sizes == res["max_list"]).sum())
    check(int(eng._ivf.list_sizes.sum()) == len(corpus),
          "G: the lists do not hold every row")
    log({"build": res})

    before = counters.read()
    out = []
    t0 = time.perf_counter()
    for lo in range(0, len(queries), QUERY_BATCH):
        out.append(eng.search(queries[lo: lo + QUERY_BATCH], K)[1])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ids = np.concatenate(out)
    check(ids.shape == (len(queries), K) and (ids >= 0).all(),
          "G: search returned unfilled slots")
    res["qps"] = len(queries) / secs
    res["recall_at_10"] = recall_at_k(ids, gt)
    res["search_launches"] = {k: v - before[k]
                              for k, v in counters.read().items()}
    check(res["search_launches"]["beam_gather_lists"] > 0
          and res["search_launches"]["beam_gather"] == 0,
          f"G: the search ran B1's gather entry "
          f"{res['search_launches']['beam_gather']} times, its list-major "
          f"entry {res['search_launches']['beam_gather_lists']}")
    log({"search": {"phase": "G", "qps": res["qps"],
                    "recall_at_10": res["recall_at_10"]}})
    check(res["recall_at_10"] >= IVF_RECALL_FLOOR,
          f"G: recall@10 {res['recall_at_10']} under {IVF_RECALL_FLOOR}")

    # persistence: the state loads on the card and answers the same
    probe = queries[:QUERY_BATCH]
    want = eng.search(probe, K)
    t0 = time.perf_counter()
    eng2 = QuantixarEngine.from_state_dict(cfg, eng.state_dict())
    res["state_round_trip_s"] = time.perf_counter() - t0
    got = eng2.search(probe, K)
    check(np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0]),
          "G: a state_dict round trip changed the hits")
    del eng2

    # delta rows: visible at once, each its own nearest neighbour
    n0 = len(corpus)
    eng.add(new_rows)
    check(eng.delta_rows == len(new_rows) and eng.seals == 0,
          "G: new rows did not stay in the delta segment")
    hits = np.concatenate([eng.search(new_rows[lo: lo + QUERY_BATCH], K)[1]
                           for lo in range(0, len(new_rows), QUERY_BATCH)])
    res["delta_self_rank1"] = float(
        (hits[:, 0] == n0 + np.arange(len(new_rows))).mean())
    check(res["delta_self_rank1"] == 1.0,
          f"G: delta self-hit rate {res['delta_self_rank1']}")

    # masked searches: ~50 % (the probed lists) and ~5 % (the flat route)
    rng = np.random.RandomState(7)
    for sel in (0.5, 0.05):
        mask = rng.random_sample(len(eng)) < sel
        d, ids = eng.search(probe, K, mask=mask)
        ok = ids >= 0
        check(bool(ok.all()), f"G: masked search ({sel}) unfilled")
        check(bool(mask[ids[ok]].all()),
              f"G: masked search ({sel}) returned a masked-out row")
        mask_gt = exact_topk(torch, eng.vectors, probe, "cosine", K,
                             mask=mask)
        res[f"mask_{sel}_recall_at_10"] = recall_at_k(ids, mask_gt)
    check(res["mask_0.05_recall_at_10"] >= 0.999,
          f"G: exact flat route recall {res['mask_0.05_recall_at_10']}")
    res["launches"] = counters.read()
    for kname in PHASE_KERNELS["G"]:
        check(res["launches"][kname] > 0,
              f"G: kernel {kname} never launched")
    # after the launch count: these launches are measurements.  B5 where
    # the coarse probe runs it: Q = 1,024 prepped queries against the
    # (nlist, D) centroids at k = nprobe, past the fused entry's fast k
    with capture_probes() as probes:
        for lo in range(0, SETS * QUERY_BATCH, QUERY_BATCH):
            eng.search(queries[lo: lo + QUERY_BATCH], K)
    check(len(probes) == SETS and all(
        c[0].shape[0] == QUERY_BATCH and c[1].shape[0] == IVF_NLIST
        and c[2:] == (IVF_NPROBE, "l2") for c in probes),
          f"G: {len(probes)} coarse probes for {SETS} batches")
    res["probe_row"] = ivf_probe_row(torch, probes, log)
    res["lists_row"], res["b1_row"] = ivf_lists_rows(torch, eng, queries,
                                                     log)
    log({"phase_result": {k: v for k, v in res.items()
                          if k not in ROW_KEYS}})
    del eng
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase H: the sharded collection and the service plane on the card
# ---------------------------------------------------------------------------

def same_hits(got, want, tag):
    """Batches of hit lists equal: ids in order and payloads, scores within
    B5's tolerance, ids of a near-tie (scores within it) allowed to swap.
    Returns the largest score difference."""
    worst = 0.0
    check(len(got) == len(want), f"{tag}: {len(got)} rows, {len(want)} wanted")
    for g, w in zip(got, want):
        check(len(g) == len(w), f"{tag}: a row of {len(g)} hits, {len(w)} "
                                "wanted")
        ws = [h.score for h in w]
        for a, b in zip(g, w):
            diff = abs(a.score - b.score)
            worst = max(worst, diff)
            # unit rows: B5's tolerance, rtol + 1e-5 * |q| |x|
            check(diff <= RTOL * abs(b.score) + ATOL_PER_NORM,
                  f"{tag}: score {a.score} vs {b.score}")
            if a.id != b.id:
                tied = {h.id for h, s in zip(w, ws)
                        if abs(s - b.score)
                        <= RTOL * abs(b.score) + ATOL_PER_NORM}
                check(a.id in tied, f"{tag}: id {a.id} vs {b.id}")
            else:
                check(a.payload == b.payload, f"{tag}: payload of {a.id}")
    return worst


def http_singles(url, collection, queries):
    """Each query alone over HTTP from SINGLE_THREADS threads of a client
    process of its own (scripts/http_load.py), so that the latencies are
    not paced by this process's interpreter, which the server runs in;
    returns (hit lists, per-query seconds, wall seconds)."""
    import types

    import numpy as np

    tmp = tempfile.mkdtemp(prefix="quantixar-load-")
    try:
        qpath, out = os.path.join(tmp, "q.npy"), os.path.join(tmp, "o.json")
        np.save(qpath, np.asarray(queries, dtype=np.float32))
        path = os.environ.get("PYTHONPATH")
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")
               + (os.pathsep + path if path else "")}
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "scripts", "http_load.py"),
             "--url", url, "--collection", collection, "--queries", qpath,
             "--k", str(K), "--threads", str(SINGLE_THREADS), "--out", out],
            env=env, capture_output=True, text=True, timeout=600)
        check(os.path.exists(out), "H: the HTTP load client wrote nothing: "
                                   f"{proc.stderr[-2000:]}")
        with open(out) as f:
            load = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not load["errors"] and proc.returncode == 0,
          f"H: HTTP single queries failed: {load['errors'][:3]} "
          f"{proc.stderr[-2000:]}")
    hits = [[types.SimpleNamespace(id=i, score=s, payload=p)
             for i, s, p in row] for row in load["hits"]]
    return hits, load["lat_s"], load["seconds"]


def run_cluster(torch, corpus, queries, gt, counters, log):
    """Phase H: a sharded, replicated exact collection on the card against
    a single-engine one, embedded and over HTTP, then failover and
    save / load."""
    import numpy as np

    from repro_torch.api import (BoolField, Database, KeywordField,
                                 NumericField, QuantixarClient,
                                 ShardedCollection, ShardUnavailable,
                                 TextField, VectorField)
    from repro_torch.core import recall_at_k
    from repro_torch.serving.http import QuantixarHTTPServer
    from repro_torch.serving.service import QuantixarService

    n = len(corpus)
    ids = [str(i) for i in range(n)]
    # no cut: the full 1M rows at 4 x 2 finish well inside the time limit
    res = {"phase": "H", "n": n, "dim": int(corpus.shape[1]),
           "shards": SHARDS, "replicas": REPLICAS, "cuts": []}
    payloads, _ = exact_payloads(n, seed=3)
    fields = (KeywordField("category"), NumericField("price"),
              BoolField("in_stock"), TextField("title"))
    vector = VectorField(dim=128, metric="cosine", index="flat")
    counters.reset()
    db = Database()                                   # the card
    sharded = db.create_collection(name="sharded", vector=vector,
                                   fields=fields, shards=SHARDS,
                                   replicas=REPLICAS)
    single = db.create_collection(name="single", vector=vector,
                                  fields=fields)
    check(isinstance(sharded, ShardedCollection), "H: not sharded")
    for name, col in (("sharded", sharded), ("single", single)):
        t0 = time.perf_counter()
        for lo in range(0, n, UPSERT_BATCH):
            col.upsert(ids[lo: lo + UPSERT_BATCH],
                       corpus[lo: lo + UPSERT_BATCH],
                       payloads[lo: lo + UPSERT_BATCH])
        res[f"{name}_upsert_rows_per_s"] = n / (time.perf_counter() - t0)
    del payloads
    check(len(sharded) == n and sum(
        s["rows"] for s in sharded.shard_stats()) == n,
        "H: the shards do not hold every row")
    res["rows_per_shard"] = [s["rows"] for s in sharded.shard_stats()]
    log({"cluster": "upsert", **res})

    probe = queries[:QUERY_BATCH]
    t0 = time.perf_counter()
    want = single.query(probe).top_k(K).run()
    res["single_batch_s"] = time.perf_counter() - t0
    sharded.query(probe[:8]).top_k(K).run()           # warm the pool
    # the shards' scans are kept: B5 is held on one shard's at the end
    with capture_topk([QUERY_BATCH, SHARD_SMALL_Q]) as scans:
        t0 = time.perf_counter()
        emb = sharded.query(probe).top_k(K).run()
        res["sharded_batch_s"] = time.perf_counter() - t0
        small = sharded.query(probe[:SHARD_SMALL_Q]).top_k(K).run()
    scans = {nq: c[:1] for nq, c in scans.items()}
    check(all(scans.values()), "H: the shards' scans did not run l2_topk")
    res["sharded_vs_single_max_score_diff"] = same_hits(
        emb, want, "H: sharded vs single")
    same_hits(small, emb[:SHARD_SMALL_Q], "H: a small batch vs the batch")
    res["sharded_vs_single_ids_equal"] = \
        [[h.id for h in r] for r in emb] == [[h.id for h in r] for r in want]

    service = QuantixarService(db)
    server = QuantixarHTTPServer(service, host="127.0.0.1", port=0).start()
    try:
        client = QuantixarClient(server.url, timeout=120)
        remote = client.collection("sharded")
        t0 = time.perf_counter()
        wire = remote.query(probe).top_k(K).run()
        res["http_batch_s"] = time.perf_counter() - t0
        check([[(h.id, h.score, h.payload) for h in r] for r in wire]
              == [[(h.id, h.score, h.payload) for h in r] for r in emb],
              "H: HTTP hits differ from the embedded ones")
        # single vectors over HTTP from 32 threads of a client process,
        # coalesced by the sharded collection's batcher behind the server
        single_q = queries[:SINGLE_QUERIES]
        before = sharded.stats()
        singles, lat, secs = http_singles(server.url, "sharded", single_q)
        rows = hit_rows(singles)
        check((rows >= 0).all(), "H: an HTTP single query came back short")
        after = sharded.stats()
        batches = after["serving_batches_served"] - \
            before["serving_batches_served"]
        served = after["serving_requests_served"] - \
            before["serving_requests_served"]
        res["http_single_qps"] = len(single_q) / secs
        res["http_single_p50_ms"] = float(np.percentile(lat, 50) * 1e3)
        res["http_single_p99_ms"] = float(np.percentile(lat, 99) * 1e3)
        res["http_single_mean_batch"] = served / max(batches, 1)
        res["http_single_client"] = "scripts/http_load.py, own process"
        check(served == len(single_q),
              f"H: the batcher served {served} of {len(single_q)} requests")
        check(res["http_single_mean_batch"] > 1,
              "H: the batcher never coalesced HTTP requests")
        # each answer is its own query's: the batcher's batches take B5's
        # small-Q path, with the hits of the 1,024-query batch, near-ties
        # aside, and the exact recall of phase E's singles
        res["http_single_recall_at_10"] = recall_at_k(
            rows, gt[:SINGLE_QUERIES])
        check(res["http_single_recall_at_10"] >= EXACT_RECALL_FLOOR,
              f"H: HTTP single recall {res['http_single_recall_at_10']}")
        m = min(len(rows), len(emb))
        res["http_single_rows_equal_batch"] = float(np.mean(
            (rows[:m] == hit_rows(emb)[:m]).all(axis=1)))
        same_hits(singles[:m], emb[:m], "H: HTTP singles vs embedded batch")
    finally:
        server.shutdown(close_service=False)
    log({"cluster": "http", **res})

    # replica failover: the primary of shard 0 down, then the whole shard
    sharded.set_replica_health(0, 0, False)
    same_hits(sharded.query(probe).top_k(K).run(), emb, "H: failover")
    sharded.set_replica_health(0, 1, False)
    try:
        sharded.query(probe[:4]).top_k(K).run()
        dark = False
    except ShardUnavailable:
        dark = True
    check(dark, "H: a dark shard did not raise ShardUnavailable")
    sharded.set_replica_health(0, 0, True)
    sharded.set_replica_health(0, 1, True)
    same_hits(sharded.query(probe).top_k(K).run(), emb, "H: recovered")
    res["failover"] = True

    # persistence of the sharded database on the card
    tmp = tempfile.mkdtemp(prefix="quantixar-smoke-")
    try:
        db.drop_collection("single")
        t0 = time.perf_counter()
        db.save(tmp)
        res["save_s"] = time.perf_counter() - t0
        db.close()
        del db, sharded, single
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        loaded = Database.load(tmp)                   # the card
        res["load_s"] = time.perf_counter() - t0
        col = loaded.collection("sharded")
        check(isinstance(col, ShardedCollection) and col.num_shards == SHARDS
              and col.schema.replicas == REPLICAS and len(col) == n,
              "H: the loaded collection lost its layout or rows")
        got = col.query(probe).top_k(K).run()
        check([[(h.id, h.score) for h in r] for r in got]
              == [[(h.id, h.score) for h in r] for r in emb],
              "H: hits differ after save and load")
        res["checkpoint_gb"] = sum(
            os.path.getsize(os.path.join(r, f))
            for r, _, fs in os.walk(tmp) for f in fs) / 2**30
        loaded.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["launches"] = counters.read()
    for kname in PHASE_KERNELS["H"]:
        check(res["launches"][kname] > 0,
              f"H: kernel {kname} never launched")
    log({"phase_result": res})
    # after the launch count: B5 on one shard's unit rows, at the batch's
    # Q = 1,024 and the batcher's largest bucket
    res["shard_rows"] = [captured_topk_row(torch, scans[nq], log,
                                           inputs="H shard scan")
                         for nq in (QUERY_BATCH, SHARD_SMALL_Q)]
    del scans
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase I: the distributed search on the card
# ---------------------------------------------------------------------------

def ids_agree(torch, got_i, want_i, want_d, tol):
    """Whether two (Q, k) top-k lists agree, ties aside: wherever their ids
    differ, the id ``got`` holds sits in ``want`` at a distance within
    ``tol`` (Q, k) of the position's, or is missing from it where the
    position lies within ``tol`` of the k-th distance.  Returns (agree,
    the count of positions whose ids differ)."""
    differ = got_i != want_i
    eq = got_i[:, :, None] == want_i[:, None, :]
    present = eq.any(-1)
    at = want_d.gather(1, eq.int().argmax(-1))
    near = (at - want_d).abs() <= tol
    edge = want_d >= want_d[:, -1:] - tol
    ok = ~differ | (present & near) | (~present & edge)
    return bool(ok.all()), int(differ.sum())


def run_distributed(torch, corpus, queries, quant_state, counters, log):
    """Phase I: the distributed search (``repro_torch.distributed``) on the
    card under ``quantixar-db``'s settings, flat (cosine as -q.x on unit
    rows, and l2), PQ and BQ: at world 1 on NCCL in both modes, the query
    batches through ``device_put_batches``, held to the exact scans; then
    one process plays the ranks of 4 row shards ("rows") and of 2 row x 2
    model shards ("dims") through the module's per-rank functions on one
    batch each, held to world 1's answer."""
    import torch.distributed as dist

    from repro_torch.configs.quantixar_db import CONFIG as DB
    from repro_torch.core.bq import BinaryQuantizer, BQConfig
    from repro_torch.core.distances import normalize
    from repro_torch.core.hnsw_build import preprocess_vectors
    from repro_torch.core.pq import PQConfig, ProductQuantizer
    from repro_torch.data import device_put_batches
    from repro_torch.distributed import search as ds
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_local_mesh, mesh_axis_sizes

    t_phase = time.perf_counter()
    n, dim = corpus.shape
    k, qb = DB.k, DB.query_batch
    res = {"phase": "I", "n": n, "dim": dim, "k": k, "query_batch": qb,
           "queries": len(queries), "metric": DB.metric,
           "reduced": DIST_REDUCED}
    counters.reset()
    mesh = make_local_mesh(1, 1)                    # the card: NCCL
    res["backend"] = dist.get_backend()
    check(res["backend"] == "nccl" and dist.get_world_size() == 1
          and mesh_axis_sizes(mesh) == {"data": 1, "model": 1},
          f"I: the world-1 mesh is {mesh_axis_sizes(mesh)} on "
          f"{res['backend']}")
    pq = ProductQuantizer(PQConfig(m=DB.pq_m, k=DB.pq_k, metric=DB.metric))
    pq.load_state_dict(quant_state["pq"])
    bq = BinaryQuantizer(BQConfig(bits=DB.bq_bits))
    bq.load_state_dict(quant_state["bq"])
    x_raw = torch.as_tensor(corpus, device="cuda")
    # case -> (kind, scan metric, global corpus / codes, feature width)
    cases = {"flat_cosine": ("flat", "dot", normalize(x_raw), dim),
             "flat_l2": ("flat", "l2", x_raw, dim),
             "pq": ("pq", "adc", pq.encode(x_raw), DB.pq_m),
             "bq": ("hamming", "hamming", bq.encode(x_raw), bq.config.words)}
    makers = {"flat_cosine": lambda mode: ds.make_flat_search(
                  mesh, k=k, metric="cosine", dim=dim, mode=mode),
              "flat_l2": lambda mode: ds.make_flat_search(
                  mesh, k=k, metric="l2", dim=dim, mode=mode),
              "pq": lambda mode: ds.make_pq_search(
                  mesh, k=k, m_subspaces=DB.pq_m, mode=mode),
              "bq": lambda mode: ds.make_hamming_search(
                  mesh, k=k, words=bq.config.words, mode=mode)}
    unit = preprocess_vectors(queries, "cosine")     # normalised once
    batches = [{"unit": unit[lo: lo + qb], "raw": queries[lo: lo + qb]}
               for lo in range(0, len(queries), qb)]

    def query_side(case, b):
        """A batch's global query array for a case: unit rows, raw rows,
        the PQ LUTs or the BQ words."""
        if case == "flat_cosine":
            return b["unit"]
        if case == "flat_l2":
            return b["raw"]
        return pq.lut(b["raw"]) if case == "pq" else bq.encode(b["raw"])

    # world 1 on NCCL: every batch through the pipeline, in both modes
    out, res["qps"] = {}, {}
    for case, (_, _, x, width) in cases.items():
        for mode in ("rows", "dims"):
            fn = makers[case](mode)
            block = ds.local_block(x, mesh, mode, dim=width)

            def search(b):
                return fn(block, ds.local_block(query_side(case, b), mesh,
                                                mode, rows=False, dim=width))

            # warm-up: the NCCL communicators, the caches
            search({key: torch.as_tensor(v, device="cuda")
                    for key, v in batches[0].items()})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = [search(b) for b in device_put_batches(iter(batches))]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            check(all(d.shape == (len(b["raw"]), k) and i.dtype == torch.int32
                      and bool(torch.isfinite(d).all())
                      and bool(((i >= 0) & (i < n)).all())
                      for (d, i), b in zip(got, batches)),
                  f"I: {case} {mode}: malformed results")
            out[(case, mode)] = got
            res["qps"][f"{case}/{mode}"] = len(queries) / secs
            log({"search": {"phase": "I", "case": case, "mode": mode,
                            "qps": len(queries) / secs, "seconds": secs}})
        # at world 1 no axis splits anything: the two modes are one path
        check(all(torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
                  for a, b in zip(out[(case, "rows")], out[(case, "dims")])),
              f"I: {case}: the modes differ at world 1")

    # one process plays the shards, through the module's per-rank
    # functions, on the first batch
    b0 = {key: torch.as_tensor(v, device="cuda")
          for key, v in batches[0].items()}
    res["emulation"] = {}
    for case, (kind, metric, x, width) in cases.items():
        q = query_side(case, b0)
        w_d, w_i = out[(case, "rows")][0]
        t0 = time.perf_counter()
        r_d, r_i = ds.emulate_search(kind, metric, x, q, k, DIST_ROWS,
                                     "rows", width)
        d_d, d_i = ds.emulate_search(kind, metric, x, q, k, DIST_DIMS,
                                     "dims", width)
        torch.cuda.synchronize()
        emu = {"seconds": time.perf_counter() - t0,
               "rows_bit_equal": torch.equal(r_i, w_i) and torch.equal(
                   r_d.view(torch.int32), w_d.view(torch.int32))}
        check(emu["rows_bit_equal"],
              f"I: {case}: {DIST_ROWS} row shards differ from world 1")
        if kind == "hamming":
            # integer sums: the same bits in any order
            tol = torch.zeros_like(w_d)
        elif kind == "pq":
            tol = PQ_DIMS_RTOL * w_d.abs()
        else:
            tol = RTOL * w_d.abs() + ATOL_PER_NORM * (
                q.norm(dim=1)[:, None] * x.norm(dim=1).max())
        err = (d_d - w_d).abs()
        agree, differ = ids_agree(torch, d_i, w_i, w_d, tol)
        emu.update({"dims_max_abs_err": float(err.max()),
                    "dims_ids_differ": differ,
                    "dims_bit_equal": torch.equal(d_i, w_i)
                    and torch.equal(d_d, w_d)})
        check(bool((err <= tol).all()) and agree,
              f"I: {case}: the {DIST_DIMS} emulation differs from world 1 "
              f"beyond ties and tolerance ({emu})")
        res["emulation"][case] = emu
        log({"emulation": {"phase": "I", "case": case, **emu}})
    res["launches"] = counters.read()
    for kname in PHASE_KERNELS["I"]:
        check(res["launches"][kname] > 0, f"I: kernel {kname} never launched")

    # after the launch count: the exact scans.  Flat: recall@k against
    # torch.topk over the plain distances (ties aside); PQ and BQ: the
    # quantizers' own exact scans, ids and distances equal
    x_cos, x_l2 = cases["flat_cosine"][2], cases["flat_l2"][2]
    for case in cases:
        hits = 0
        for j, b in enumerate(batches):
            if case.startswith("flat"):
                qd = torch.as_tensor(query_side(case, b), device="cuda")
                d = (ref.dot_distance_ref(qd, x_cos) if case == "flat_cosine"
                     else ref.l2_distance_ref(qd, x_l2))
                want = torch.topk(d, k, dim=1, largest=False).indices
                del d
                got = out[(case, "rows")][j][1].long()
                hits += int((got[:, :, None] == want[:, None, :]).any(-1)
                            .sum())
                continue
            raw = torch.as_tensor(b["raw"], device="cuda")
            codes = cases[case][2]
            w_d, w_i = (pq.search(codes, raw, k) if case == "pq"
                        else bq.search(codes, raw, k))
            for mode in ("rows", "dims"):
                g_d, g_i = out[(case, mode)][j]
                check(torch.equal(g_i, w_i) and torch.equal(g_d, w_d),
                      f"I: {case} {mode}: batch {j} differs from the "
                      f"quantizer's exact scan")
        if case.startswith("flat"):
            res[f"{case}_recall_at_{k}"] = hits / (len(queries) * k)
            check(res[f"{case}_recall_at_{k}"] >= DIST_RECALL_FLOOR,
                  f"I: {case}: recall@{k} {res[f'{case}_recall_at_{k}']}")
        else:
            res[f"{case}_equals_exact_scan"] = True
        torch.cuda.empty_cache()

    # B6 and B7 where the "dims" ranks run them: model shard 0's halves
    # (m 8, W 4) over consecutive chunks of its row shard
    pq_codes, words = cases["pq"][2], cases["bq"][2]
    half_m, half_w = DB.pq_m // 2, bq.config.words // 2
    lut = pq.lut(b0["raw"])[:, :half_m].contiguous()
    codes_h = pq_codes[:, :half_m].contiguous()
    q_words = bq.encode(b0["raw"])[:, :half_w].contiguous()
    words_h = words[:, :half_w].contiguous()
    chunk = ds.CHUNK
    res["pq_row"] = pq_adc_row(torch, lut, [
        codes_h[i * chunk:(i + 1) * chunk] for i in range(SETS)], log,
        inputs="I dims split")
    res["hamming_row"] = hamming_row(torch, q_words, [
        words_h[i * chunk:(i + 1) * chunk] for i in range(SETS)], log,
        inputs="I dims split")
    # B5's matrix entry there: dot mode over model shard 0's half of the
    # features (D 64), for the cosine rows and for l2's raw rows
    half = dim // 2
    res["l2_rows"] = []
    for case, xf, qd in (("flat_cosine", x_cos, b0["unit"]),
                         ("flat_l2", x_l2, b0["raw"])):
        x_h = xf[:, :half].contiguous()
        q_h = qd[:, :half].contiguous()
        res["l2_rows"].append(l2_distance_row(torch, "dot", [
            (q_h, x_h[i * chunk:(i + 1) * chunk]) for i in range(SETS)],
            log, inputs=f"I dims split, {case}"))
        del x_h, q_h
    res["seconds"] = time.perf_counter() - t_phase
    log({"phase_result": {key: v for key, v in res.items()
                          if key not in ROW_KEYS}})
    dist.destroy_process_group()
    del cases, out, x_raw, x_cos, x_l2
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase F: xlstm-1.3b serving through repro_torch.models
# ---------------------------------------------------------------------------

def slstm_kernel_checks(torch, layer, n_heads, log):
    """B8 against its plain version: at the JAX package's kernel-test shapes
    (tests/test_kernels.py, R = 0.3·N(0, 1)), at the smoke width (d = 64,
    2 heads) and at full width (B = 8, S = 2,048, d = 2,048, 4 heads) with
    the model's first sLSTM layer's R and b, each in bf16 and fp32; gates
    N(0, 1), the scale of the normed x @ w_in.

    bound: the recurrent product's 2·B·S·4d·blk flops at the fp32 rate
    against the gates, the output, R and b moved once; the S sequential
    steps add a latency floor this bound does not count.  library_ms is
    null: no PyTorch call computes this stabilised exp-gate cell with a
    block-diagonal recurrence (``nn.LSTM`` is another function).  Each row
    names the kernel's path and layout (``slstm.last_launch``); at full
    width ``floor_ms`` is the cluster path's step floor, the same clusters
    doing only the S steps' h exchange and waits (``slstm.step_floor``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm as slstm_mod
    from repro_torch.kernels.slstm import slstm_sequence

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    d_full = layer.w_in.shape[0]
    # (B, S, d, H, R's scale); the last row takes the layer's R and b
    shapes = [(2, 64, 32, 4, 0.3), (1, 32, 16, 2, 0.3), (3, 96, 64, 8, 0.3),
              (2, 128, 64, 2, 32 ** -0.5),
              (PREFILL_B, PREFILL_S, d_full, n_heads, None)]
    rows = []
    for b, s, d, h, scale in shapes:
        blk = d // h
        if scale is None:
            r, bias = layer.r.detach(), layer.b.detach()
        else:
            r = scale * torch.randn((4, h, blk, blk), generator=gen,
                                    device="cuda")
            bias = torch.randn((4 * d,), generator=gen, device="cuda")
        g32 = torch.randn((b, s, 4 * d), generator=gen, device="cuda")
        # a second input set for the timer
        g32b = torch.randn((b, s, 4 * d), generator=gen, device="cuda")
        for dtype in ("bfloat16", "float32"):
            g = g32.to(getattr(torch, dtype))
            gb = g32b.to(g.dtype)
            got = slstm_sequence(g, r, bias, n_heads=h)
            layout = dict(slstm_mod.last_launch)
            again = slstm_sequence(g, r, bias, n_heads=h)
            want = ref.slstm_sequence_ref(g, r, bias, h)
            torch.cuda.synchronize()
            check(torch.equal(got, again),
                  f"slstm {dtype} B={b} S={s} d={d} H={h}: two calls differ")
            err = (got.float() - want.float()).abs().max().item()
            check(err <= SLSTM_ATOL[dtype],
                  f"slstm {dtype} B={b} S={s} d={d} H={h}: max err {err}")
            esize = g.element_size()
            nbytes = b * s * 4 * d * esize + b * s * d * esize \
                + r.numel() * 4 + bias.numel() * 4
            b_ms, b_by = bound(nbytes, 2 * b * s * 4 * d * blk)
            plain_reps = 25 if s <= 128 else 5
            # the device timer issues the cooperative launches back to back
            # (no graph): one call is long enough that the host never
            # paces it
            rows.append({
                "name": "slstm", "dtype": dtype, "B": b, "S": s, "d": d,
                "H": h, "max_abs_err": err,
                **timing(torch, [lambda x=x: slstm_sequence(
                    x, r, bias, n_heads=h) for x in (g, gb)], graph=False),
                **plain_timing(torch, [lambda x=x: ref.slstm_sequence_ref(
                    x, r, bias, h) for x in (g, gb)], reps=plain_reps,
                    warmup=1),
                "plain_reps": plain_reps,
                "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
                "library_ms": None, **layout})
            if scale is None:
                check(layout["path"] == "cluster",
                      f"slstm full width took the {layout['path']} path")
                rows[-1]["floor_ms"] = device_ms(torch, [
                    lambda: slstm_mod.step_floor(b, s, d, h, g.device)],
                    graph=False)
            rows[-1]["share"] = b_ms / rows[-1]["ms"]
            log(rows[-1])
            del got, again, want, gb
        del g32b
    return rows


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def slstm_backward_checks(torch, layer, n_heads, log):
    """B8ᵀ (``slstm_backward``) against its plain reverse loop
    (``ref.slstm_sequence_backward_ref`` + ``slstm_param_grads``) at B8's
    check shapes (``slstm_kernel_checks``: the JAX package's kernel-test
    shapes and the smoke width, on the l2 and the cluster path, and phase
    F's full width B = 8, S = 2,048, d = 2,048, 4 heads with the model's
    first sLSTM layer's R and b), bf16 and fp32 gates N(0, 1), a cotangent
    N(0, 1), on one saved forward (B8's saving entry): dgates (and the f32
    dpre), dr and db by relative L2 (SLSTM_BWD_RTOL); two calls bit-equal.

    bound: the reverse product's 2·B·S·4d·blk flops at the fp32 rate (the
    forward's), against the save, dy and R read once and dpre and dgates
    written once.  library_ms is null: no PyTorch call computes this
    cell's backward.  Each row names B8ᵀ's path and layout
    (``slstm.last_backward_launch``); at full width the path must be the
    cluster one and ``floor_ms`` is its step floor, the same clusters doing
    only the S steps' exchange of partial sums and its waits
    (``slstm.backward_step_floor``).  The device timer issues launches back
    to back (no graph), as B8's; the plain loop is timed per call (3 calls
    at full width)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm as slstm_mod

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    d_full = layer.w_in.shape[0]
    # slstm_kernel_checks' shapes: (B, S, d, H, R's scale); the last row
    # takes the layer's R and b
    shapes = [(2, 64, 32, 4, 0.3), (1, 32, 16, 2, 0.3), (3, 96, 64, 8, 0.3),
              (2, 128, 64, 2, 32 ** -0.5),
              (PREFILL_B, PREFILL_S, d_full, n_heads, None)]
    rows = []
    for b, s, d, h, scale in shapes:
        blk = d // h
        if scale is None:
            r, bias = layer.r.detach(), layer.b.detach()
        else:
            r = scale * torch.randn((4, h, blk, blk), generator=gen,
                                    device="cuda")
            bias = torch.randn((4 * d,), generator=gen, device="cuda")
        g32 = torch.randn((b, s, 4 * d), generator=gen, device="cuda")
        dy32 = torch.randn((b, s, d), generator=gen, device="cuda")
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            g, dy = g32.to(dt), dy32.to(dt)
            _, saved = slstm_mod.slstm_sequence_save(g, r, bias, n_heads=h)
            forward_path = slstm_mod.last_launch["path"]
            dgates, dpre = slstm_mod.slstm_backward(dy, saved, r, n_heads=h)
            layout = dict(slstm_mod.last_backward_launch)
            dr, db = ref.slstm_param_grads(saved, dpre, h)
            want_g, want_p = ref.slstm_sequence_backward_ref(dy, saved, r, h,
                                                             dt)
            want_r, want_b = ref.slstm_param_grads(saved, want_p, h)
            torch.cuda.synchronize()
            at = f"slstm_backward {dtype} B={b} S={s} d={d} H={h}"
            errs = {"dgates": rel_l2(dgates, want_g),
                    "dpre": rel_l2(dpre, want_p),
                    "dr": rel_l2(dr, want_r), "db": rel_l2(db, want_b)}
            limits = {"dgates": SLSTM_BWD_RTOL[dtype],
                      "dpre": SLSTM_BWD_RTOL["float32"],
                      "dr": SLSTM_BWD_RTOL["float32"],
                      "db": SLSTM_BWD_RTOL["float32"]}
            for k, e in errs.items():
                check(e <= limits[k], f"{at}: {k} relative L2 {e} over "
                      f"{limits[k]}")
            again, again_p = slstm_mod.slstm_backward(dy, saved, r,
                                                      n_heads=h)
            torch.cuda.synchronize()
            check(torch.equal(again, dgates) and torch.equal(again_p, dpre),
                  f"{at}: two calls differ")
            esize = g.element_size()
            nbytes = saved.numel() * 4 + dy.numel() * esize + r.numel() * 4 \
                + dpre.numel() * 4 + (0 if dgates is dpre
                                      else dgates.numel() * esize)
            b_ms, b_by = bound(nbytes, 2 * b * s * 4 * d * blk)
            plain_reps = 3 if scale is None else 5
            row = {"name": "slstm_backward", "dtype": dtype, "B": b, "S": s,
                   "d": d, "H": h,
                   "max_abs_err": (dgates.float() - want_g.float()).abs()
                   .max().item(), "rel_l2": errs, "rel_l2_limits": limits,
                   "forward_path": forward_path,
                   **timing(torch, [lambda: slstm_mod.slstm_backward(
                       dy, saved, r, n_heads=h)], graph=False),
                   **plain_timing(torch, [
                       lambda: ref.slstm_sequence_backward_ref(
                           dy, saved, r, h, dt)], reps=plain_reps, warmup=1),
                   "plain_reps": plain_reps, "bound_ms": b_ms,
                   "bound_by": b_by,
                   "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "library_ms": None, **layout}
            if scale is None:
                check(layout["path"] == "cluster",
                      f"{at}: B8ᵀ took the {layout['path']} path")
                row["floor_ms"] = device_ms(torch, [
                    lambda: slstm_mod.backward_step_floor(b, s, d, h,
                                                          g.device)],
                    graph=False)
            row["share"] = b_ms / row["ms"]
            log(row)
            rows.append(row)
            del saved, dgates, dpre, want_g, want_p, again, again_p, dr, db
            torch.cuda.empty_cache()
    return rows


def run_xlstm(torch, counters, log):
    """Phase F: xlstm-1.3b at full width on the card, serving (no
    autograd): B8's and B8ᵀ's checks, the prefill, greedy generation, and
    the fp32 consistency checks."""
    with torch.no_grad():
        return _run_xlstm(torch, counters, log)


def _run_xlstm(torch, counters, log):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import zipf_tokens
    from repro_torch.models import forward, init_params

    cfg = get_config(XLSTM)
    n_slstm = sum(bt == "slstm" for bt in cfg.block_pattern) * cfg.n_units
    res = {"phase": "F", "model": XLSTM, "param_count": cfg.param_count()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    res["param_numel"] = sum(p.numel() for p in model.parameters())
    first_slstm = next(b.slstm for b in model.layers
                       if b.block_type == "slstm")
    rows = slstm_kernel_checks(torch, first_slstm, cfg.n_heads, log)
    torch.cuda.empty_cache()
    rows += slstm_backward_checks(torch, first_slstm, cfg.n_heads, log)

    # 1. embedding / scoring requests: 8 prompts of 2,048 tokens (a warm-up
    # forward of 8 x 256 first: cuBLAS handles, the kernel's library)
    V = cfg.vocab_size
    toks = torch.as_tensor(zipf_tokens(np.random.RandomState(0),
                                       (PREFILL_B, PREFILL_S), V),
                           device="cuda")
    res.update(lm_prefill(torch, model, cfg, toks, None, "F", counters))
    res["launches"] = counters.read()
    prefill_s = res["prefill_s"]
    check(res["launches"]["slstm"] == n_slstm,
          f"F: slstm called {res['launches']['slstm']} times in one "
          f"prefill, want {n_slstm}")
    full = next(r for r in rows if r["name"] == "slstm"
                and r["dtype"] == "bfloat16" and r["S"] == PREFILL_S)
    res["slstm_ms_per_prefill"] = full["ms"] * n_slstm
    res["slstm_share_of_prefill"] = full["ms"] * n_slstm / (prefill_s * 1e3)
    log({"xlstm": "prefill", **res})

    # 2. generation requests: 8 prompts of 128 tokens teacher-forced through
    # the greedy serve step, then 32 tokens generated each
    prompts = torch.as_tensor(zipf_tokens(np.random.RandomState(1),
                                          (PREFILL_B, PROMPT_S), V),
                              device="cuda")
    out, gen_ids = lm_generate(torch, model, cfg, prompts, GEN_TOKENS, None,
                               "F")
    res.update(out)
    res["generated_first_row"] = gen_ids[0].tolist()
    log({"xlstm": "generate", **{k: res[k] for k in (
        "prompt_ms_per_step", "decode_ms_per_step", "decode_tokens_per_s",
        "generated_first_row")}})

    # 3. end-to-end consistency in fp32, the same weights: the kernel's
    # forward against the plain one, teacher-forced decode against forward
    cfg32 = cfg.with_overrides(dtype="float32")
    toks = torch.as_tensor(zipf_tokens(np.random.RandomState(2),
                                       (PREFILL_B, PROMPT_S), V),
                           device="cuda")
    got, _ = forward(model, {"tokens": toks}, cfg32)
    want, _ = forward(model, {"tokens": toks}, cfg32, force_ref=True)
    scale = want.abs().max().item()
    res["fp32_kernel_vs_plain_max_abs"] = (got - want).abs().max().item()
    check(res["fp32_kernel_vs_plain_max_abs"] <= LOGIT_REL_TOL * scale,
          f"F: fp32 forward, kernel vs plain: {res['fp32_kernel_vs_plain_max_abs']}"
          f" over {LOGIT_REL_TOL} x {scale}")
    del got, want
    res.update(lm_agreement(torch, model, cfg32, toks, None, "F"))
    del model
    torch.cuda.empty_cache()
    for kname in PHASE_KERNELS["F"]:
        check(res["launches"][kname] > 0, f"F: kernel {kname} never launched")
    log({"phase_result": res})
    return res, rows


# ---------------------------------------------------------------------------
# phases J and K: the attention, MoE, RG-LRU and encoder-decoder families
# ---------------------------------------------------------------------------

def lm_prefill(torch, model, cfg, toks, frames, tag, counters=None):
    """One prefill / scoring forward, timed after a warm-up of the first
    256 tokens (``counters`` set to 0 after it): tokens/s, peak GB, finite
    logits of the full shape."""
    from repro_torch.models import forward

    def batch(n):
        out = {"tokens": toks[:, :n]}
        if frames is not None:
            out["frames"] = frames
        return out

    b, s = toks.shape
    forward(model, batch(256), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if counters is not None:
        counters.reset()
    t0 = time.perf_counter()
    logits, aux = forward(model, batch(s), cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(tuple(logits.shape) == (b, s, cfg.vocab_size)
          and logits.dtype == torch.float32, f"{tag}: logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux)),
          f"{tag}: non-finite logits or aux")
    out = {"prefill_s": secs, "prefill_tokens_per_s": b * s / secs,
           "prefill_peak_gb": torch.cuda.max_memory_allocated() / 2**30,
           "aux": aux.item()}
    del logits
    torch.cuda.empty_cache()
    return out


def lm_generate(torch, model, cfg, prompts, gen_tokens, enc_out, tag,
                state=None):
    """The greedy serve step: the prompt teacher-forced, then gen_tokens
    generated, from ``state`` (default a new one).  Returns ({prompt /
    decode ms per step, ...}, ids)."""
    from repro_torch.models import init_decode_state, make_serve_step

    b, prompt_s = prompts.shape
    serve = make_serve_step(cfg)
    if state is None:
        state = init_decode_state(cfg, b, prompt_s + gen_tokens,
                                  enc_out=enc_out, params=model,
                                  device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(prompt_s):
        nxt, state = serve(model, state, prompts[:, t:t + 1])
    torch.cuda.synchronize()
    prompt_ms = (time.perf_counter() - t0) * 1e3 / prompt_s
    out, step_ms = [nxt], []
    for _ in range(gen_tokens - 1):
        t1 = time.perf_counter()
        nxt, state = serve(model, state, nxt)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        out.append(nxt)
    ids = torch.cat(out, dim=1)
    steps = prompt_s + gen_tokens - 1
    check(tuple(ids.shape) == (b, gen_tokens) and int(ids.min()) >= 0
          and int(ids.max()) < cfg.vocab_size,
          f"{tag}: generated ids out of range or shape {tuple(ids.shape)}")
    check(bool((state.pos == steps).all()),
          f"{tag}: decode pos {state.pos.tolist()} after {steps} steps")
    ms = statistics.median(step_ms)
    return {"prompt_ms_per_step": prompt_ms, "decode_ms_per_step": ms,
            "decode_tokens_per_s": b * 1e3 / ms}, ids


def lm_agreement(torch, model, cfg32, toks, frames, tag):
    """fp32, the same weights: teacher-forced ``decode_step`` against
    ``forward``: max abs difference <= LOGIT_REL_TOL x the largest logit,
    argmax agreement >= ARGMAX_AGREEMENT."""
    from repro_torch.models import (decode_step, encode, forward,
                                    init_decode_state)

    b, s = toks.shape
    batch = {"tokens": toks}
    enc_out = None
    if frames is not None:
        batch["frames"] = frames
        enc_out = encode(model, frames, cfg32)
    full, _ = forward(model, batch, cfg32)
    state = init_decode_state(cfg32, b, s, enc_out=enc_out, params=model,
                              device="cuda")
    dec = torch.empty_like(full)
    for t in range(s):
        step, state = decode_step(model, state, toks[:, t:t + 1], cfg32)
        dec[:, t] = step[:, 0]
    scale = full.abs().max().item()
    out = {"fp32_logit_max_abs": scale,
           "fp32_decode_vs_forward_max_abs": (dec - full).abs().max().item(),
           "fp32_argmax_agreement": (dec.argmax(-1) == full.argmax(-1))
           .float().mean().item()}
    check(out["fp32_decode_vs_forward_max_abs"] <= LOGIT_REL_TOL * scale,
          f"{tag}: fp32 decode vs forward: "
          f"{out['fp32_decode_vs_forward_max_abs']} over {LOGIT_REL_TOL} x "
          f"{scale}")
    check(out["fp32_argmax_agreement"] >= ARGMAX_AGREEMENT,
          f"{tag}: fp32 argmax agreement {out['fp32_argmax_agreement']}")
    return out


def attention_yardstick(torch, cfg, log):
    """The port's full-sequence attention (the route phase J's prefill
    takes) against one ``F.scaled_dot_product_attention`` call on the same
    q, k and v (the kv heads repeated to the query heads, outside the
    timing): device ms of each (calls back to back) and per-call ms, the
    largest difference, and a bound: the causal half of the two products'
    operations at the bf16 tensor-core peak.  The library call is timed
    here only; no path of the port takes it."""
    import torch.nn.functional as F

    from repro_torch.models import layers as L

    b, s = PREFILL_B, PREFILL_S
    nq, nkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    dt = cfg.activation_dtype
    sets = []
    for _ in range(2):
        q = torch.randn((b, s, nq, dh), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, s, nkv, dh), generator=gen, device="cuda").to(dt)
        v = torch.randn((b, s, nkv, dh), generator=gen, device="cuda").to(dt)
        sets.append((q, k, v))
    pos = torch.arange(s, dtype=torch.int32, device="cuda")[None].expand(b, s)
    route = L.attention_route(cfg, s, s, True, cfg.attn_chunk)
    check(route == "chunked", f"J: attention takes the {route} route")

    def port(q, k, v):
        return L._chunked_attention(q.reshape(b, s, nkv, nq // nkv, dh), k,
                                    v, pos, pos, True, 0, cfg.attn_chunk)

    def lib_inputs(q, k, v):
        rep = nq // nkv
        return (q.transpose(1, 2),
                k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous(),
                v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous())

    lib_sets = [lib_inputs(*x) for x in sets]

    def lib(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    got = port(*sets[0]).reshape(b, s, nq, dh).float()
    want = lib(*lib_sets[0]).transpose(1, 2).float()
    diff = (got - want).abs().amax(-1)
    err = diff.max().item()
    # each (row, position, head) against its own largest output: late
    # positions average ~2k keys, so their outputs are ~20x smaller than the
    # first ones' and an absolute limit would not see them
    rel = (diff / want.abs().amax(-1).clamp_min(1e-30)).max().item()
    check(rel <= ATTN_REL_TOL,
          f"J: attention vs scaled_dot_product_attention: {rel} of each "
          f"position's largest output (max abs {err})")
    del got, want, diff
    flops = 2 * 2 * b * nq * dh * s * (s + 1) / 2
    # q, k, v read once and the output written once, bf16
    b_ms, b_by = bound((2 * nq + 2 * nkv) * b * s * dh * 2, flops,
                       BF16_FLOP_PER_S)
    row = {"attention_yardstick": "J", "B": b, "S": s, "nq": nq, "nkv": nkv,
           "dh": dh, "route": route, "chunk": cfg.attn_chunk,
           "max_abs_err": err, "max_rel_err_per_position": rel,
           **timing(torch, [lambda x=x: port(*x) for x in sets],
                    graph=False, reps=5, warmup=1),
           **timing(torch, [lambda x=x: lib(*x) for x in lib_sets],
                    prefix="sdpa_", graph=False, reps=5, warmup=1),
           "bound_ms": b_ms, "bound_by": b_by}
    log(row)
    torch.cuda.empty_cache()
    return row


def run_qwen2(torch, counters, log):
    """Phase J: qwen2-1.5b at its full published size on the card, serving
    (no autograd)."""
    with torch.no_grad():
        return _run_qwen2(torch, counters, log)


def _run_qwen2(torch, counters, log):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import zipf_tokens
    from repro_torch.models import init_params
    from repro_torch.models import layers as L

    cfg = get_config(QWEN2)
    res = {"phase": "J", "model": QWEN2, "param_count": cfg.param_count(),
           "reduced": []}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    res["param_numel"] = sum(p.numel() for p in model.parameters())
    V = cfg.vocab_size
    toks = torch.as_tensor(zipf_tokens(np.random.RandomState(0),
                                       (PREFILL_B, PREFILL_S), V),
                           device="cuda")
    res["attention_route"] = L.attention_route(cfg, PREFILL_S, PREFILL_S,
                                               True, cfg.attn_chunk)
    counters.reset()
    res.update(lm_prefill(torch, model, cfg, toks, None, "J"))
    prompts = torch.as_tensor(zipf_tokens(np.random.RandomState(1),
                                          (PREFILL_B, PROMPT_S), V),
                              device="cuda")
    ids = {}
    for mode in ("ragged", "uniform"):
        gcfg = cfg.with_overrides(decode_pos_mode=mode)
        out, ids[mode] = lm_generate(torch, model, gcfg, prompts, GEN_TOKENS,
                                     None, f"J {mode}")
        res.update({f"{k}_{mode}": v for k, v in out.items()})
    res["launches"] = counters.read()
    check(torch.equal(ids["ragged"], ids["uniform"]),
          "J: ragged and uniform decode generated other ids")
    res["placed_decode"] = placed_decode(torch, model, cfg, prompts,
                                         ids["ragged"], log)
    res["decode_ms_per_step"] = res["decode_ms_per_step_ragged"]
    res["generated_first_row"] = ids["ragged"][0].tolist()
    log({"qwen2": "serve", **res})
    cfg32 = cfg.with_overrides(dtype="float32")
    toks = torch.as_tensor(zipf_tokens(np.random.RandomState(2),
                                       (PREFILL_B, PROMPT_S), V),
                           device="cuda")
    res.update(lm_agreement(torch, model, cfg32, toks, None, "J"))
    res["rag"] = rag_run(torch, model, cfg, log)
    del model
    torch.cuda.empty_cache()
    res["yardstick"] = attention_yardstick(torch, cfg, log)
    log({"phase_result": res})
    return res


def placed_decode(torch, model, cfg, prompts, want_ids, log):
    """Phase N (iii): J's greedy decode through ``make_serve_step`` on the
    model placed at a (1, 1) mesh (``models.convert.placement``, bound for
    the call) from a decode state placed by the policy's serve specs
    (``place_decode_state``): the same ids as the unplaced decode."""
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import init_decode_state, place_decode_state
    from repro_torch.models.convert import placement

    mesh = make_local_mesh(1, 1, device="cuda")
    pl = placement(model, ShardingPolicy(mesh))
    pl.bind(model)
    try:
        b, prompt_s = prompts.shape
        state = place_decode_state(init_decode_state(
            cfg, b, prompt_s + GEN_TOKENS, device="cuda"), cfg, pl)
        out, ids = lm_generate(torch, model, cfg, prompts, GEN_TOKENS, None,
                               "N placed decode", state=state)
    finally:
        del model.placement
    res = {"mesh": dict(pl.sizes), "seq_shards": max(state.seq_shards),
           "ids_equal_unplaced": bool(torch.equal(ids, want_ids)), **out,
           "collectives": dict(pl.counts)}
    check(res["ids_equal_unplaced"],
          "N: the placed (1, 1) decode generated other ids than J's")
    log({"placed_decode": "N " + QWEN2, **res})
    return res


def rag_run(torch, model, cfg, log):
    """J's model through ``examples/rag_serve_torch.py``'s flow once at
    its full size: 512 documents embedded (mean logits, V wide) into a
    4-shard exact collection on the card, top-3 retrieval for 8 queries,
    then 8 greedy tokens each after its best document.  Each query's top-3
    ids and distances are held to ``torch.topk`` over the plain cosine
    distances of the same embeddings on the card (TF32 off), ties aside,
    at B5's tolerance (RTOL + ATOL_PER_NORM, the rows unit)."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import rag_serve_torch as rag
    from repro_torch.core.distances import normalize
    from repro_torch.kernels import ref

    t0 = time.perf_counter()
    out = rag.rag_flow(cfg, model, device=torch.device("cuda"),
                       log=lambda *_: None)
    gen = out["generated"]
    check(len(out["retrieved"]) == rag.N_QUERIES and all(
        len(r) == rag.TOP_K and all(i.startswith("doc-") for i in r)
        for r in out["retrieved"]), f"J rag: retrieved {out['retrieved']}")
    check(gen.shape == (rag.N_QUERIES, rag.GEN_TOKENS)
          and 0 <= gen.min() and gen.max() < cfg.vocab_size,
          f"J rag: generated {gen.tolist()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = 1.0 + ref.dot_distance_ref(
        normalize(torch.as_tensor(out["query_emb"], device="cuda")),
        normalize(torch.as_tensor(out["doc_emb"], device="cuda")))
    want_d, want_i = torch.topk(plain, rag.TOP_K, dim=1, largest=False)
    got_i = torch.tensor([[int(i.split("-")[1]) for i in row]
                          for row in out["retrieved"]], device="cuda")
    got_d = torch.tensor(out["scores"], device="cuda")
    at = plain.gather(1, got_i)
    err = (got_d - at).abs()
    agree, differ = ids_agree(torch, got_i, want_i, want_d,
                              RTOL * want_d.abs() + ATOL_PER_NORM)
    check(bool((err <= RTOL * at.abs() + ATOL_PER_NORM).all()) and agree,
          f"J rag: the top-{rag.TOP_K} differ from torch.topk over the "
          f"plain distances beyond ties and tolerance (max err "
          f"{float(err.max())}, {differ} ids differ)")
    res = {"docs": rag.N_DOCS, "doc_len": rag.DOC_LEN,
           "dim": cfg.vocab_size, "shards": out["shards"],
           "retrieved_first": out["retrieved"][0],
           "max_abs_err_vs_plain": float(err.max()),
           "ids_differ_from_plain": differ,
           "retrieve_s": out["retrieve_s"],
           "generated_first_row": gen[0].tolist(),
           "seconds": time.perf_counter() - t0}
    log({"qwen2": "rag", **res})
    return res


def k_depth(torch, cfg):
    """The deepest depth, at most the published one, whose fp32 weights (the
    parameters of the model built on the meta device) fit in the card's
    free memory less K_RESERVE_GIB; and why it is cut, or None."""
    from repro_torch.models.model import Model

    def gib(n):
        model = Model(cfg.with_overrides(n_layers=n), "meta")
        return sum(p.numel() for p in model.parameters()) * 4 / 2**30

    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0] / 2**30
    depth = cfg.n_layers
    while depth > 1 and gib(depth) > free - K_RESERVE_GIB:
        depth -= 1
    if depth == cfg.n_layers:
        return depth, None
    return depth, (f"memory: {gib(cfg.n_layers):.1f} GiB of fp32 weights at "
                   f"{cfg.n_layers} layers, {gib(depth):.1f} at {depth}; "
                   f"{free:.1f} GiB free on the card less {K_RESERVE_GIB} "
                   f"for the prefill's activations and logits")


def run_families(torch, counters, log):
    """Phase K: the other eight new families at their published widths,
    depth cut only where the fp32 weights would not fit (k_depth); one
    model at a time, serving (no autograd)."""
    with torch.no_grad():
        return _run_families(torch, counters, log)


def _run_families(torch, counters, log):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import zipf_tokens
    from repro_torch.models import encode, init_params

    res = {"phase": "K", "families": {}}
    counters.reset()
    for arch in K_FAMILIES:
        cfg = get_config(arch)
        reduced = []
        depth, why = k_depth(torch, cfg)
        if why is not None:
            reduced.append(f"n_layers {cfg.n_layers} -> {depth}: {why}")
            cfg = cfg.with_overrides(n_layers=depth)
        fam = {"layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
               "param_count": cfg.param_count()}
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        model = init_params(cfg, generator=gen, device="cuda")
        torch.cuda.synchronize()
        fam["init_s"] = time.perf_counter() - t0
        fam["weights_gib"] = (sum(p.numel() for p in model.parameters())
                              * 4 / 2**30)
        V, d = cfg.vocab_size, cfg.d_model
        toks = torch.as_tensor(zipf_tokens(np.random.RandomState(0),
                                           (K_PREFILL_B, PREFILL_S), V),
                               device="cuda")
        frames = None
        if cfg.is_enc_dec:
            frames = torch.randn((K_PREFILL_B, K_FRAMES, d), generator=gen,
                                 device="cuda")
        fam.update(lm_prefill(torch, model, cfg, toks, frames, f"K {arch}"))
        enc_out = None if frames is None else encode(model, frames, cfg)
        out, gen_ids = lm_generate(torch, model, cfg, toks[:, :K_PROMPT_S],
                                   K_GEN_TOKENS, enc_out, f"K {arch}")
        fam.update(out)
        fam["generated_first_row"] = gen_ids[0].tolist()
        del enc_out
        over = K_AGREE_OVERRIDES.get(arch, {})
        reduced += [f"fp32 check: {k}={v} ({K_AGREE_WHY[k]})"
                    for k, v in over.items()]
        cfg32 = cfg.with_overrides(dtype="float32", **over)
        check_frames = None if frames is None else frames[:, :K_CHECK_S]
        fam.update(lm_agreement(torch, model, cfg32,
                                toks[:, :K_CHECK_S].contiguous(),
                                check_frames, f"K {arch}"))
        fam["reduced"] = reduced
        fam["seconds"] = time.perf_counter() - t0
        log({"family": arch, **fam})
        res["families"][arch] = fam
        del model, toks, frames, check_frames
        torch.cuda.empty_cache()
    res["launches"] = counters.read()
    log({"phase_result": res})
    return res


# ---------------------------------------------------------------------------
# phase L: training at full width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def step_timer(torch, times):
    """Times every train step that ``launch.train.train`` builds: the host
    clock around the step (ending in a synchronize) and CUDA events
    recorded before and after it on the stream; appends (wall s, event ms)
    to ``times``.  A measurement wrapper: the step itself is unchanged."""
    from repro_torch.launch import train as train_mod

    orig = train_mod.make_train_step

    def timed(*args, **kw):
        fn = orig(*args, **kw)

        def step(state, batch):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.record()
            out = fn(state, batch)
            b.record()
            b.synchronize()
            times.append((time.perf_counter() - t0, a.elapsed_time(b)))
            return out
        return step

    train_mod.make_train_step = timed
    try:
        yield
    finally:
        train_mod.make_train_step = orig


def product_params(cfg) -> int:
    """The parameters that enter a matrix product: all but an untied
    embedding table, which is only gathered (a tied one is the head)."""
    from repro_torch.models.model import Model
    model = Model(cfg, "meta")
    n = sum(p.numel() for p in model.parameters())
    return n if cfg.tie_embeddings else n - model.embed.numel()


def train_run(torch, cfg, tag, counters, log, **kw):
    """``train()`` on the card at phase L's sizes, timed step by step:
    losses (finite, the last below the first), the median step wall and
    event ms over steps 2.., tokens/s, peak GiB, the model-FLOP share, the
    kernels' launches.  Returns (result, the train output)."""
    from repro_torch.launch.train import train

    times = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    with step_timer(torch, times):
        out = train(cfg, steps=TRAIN_STEPS, global_batch=TRAIN_B,
                    seq_len=TRAIN_S, lr=TRAIN_LR, device="cuda", **kw)
    secs = time.perf_counter() - t0
    launches = counters.read()
    losses = [m["loss"] for m in out["metrics"]]
    check(len(losses) == TRAIN_STEPS and all(
        map(lambda x: x == x and abs(x) != float("inf"), losses)),
        f"{tag}: losses {losses}")
    check(losses[-1] < losses[0], f"{tag}: the loss did not fall: {losses}")
    wall = statistics.median(t for t, _ in times[1:])
    event = statistics.median(e for _, e in times[1:])
    tokens = TRAIN_B * TRAIN_S
    flops = MODEL_FLOPS_PER_PARAM_TOKEN * product_params(cfg) * tokens
    res = {"losses": losses,
           "grad_norms": [m["grad_norm"] for m in out["metrics"]],
           "steps": TRAIN_STEPS, "batch": TRAIN_B, "seq": TRAIN_S,
           "step_wall_ms": wall * 1e3, "step_event_ms": event,
           "step_wall_ms_all": [t * 1e3 for t, _ in times],
           "tokens_per_s": tokens / wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "model_tflop_per_step": flops / 1e12,
           "model_flop_share_bf16": flops / wall / BF16_FLOP_PER_S,
           "train_s": secs, "launches": launches}
    log({"train": tag, **res})
    return res, out


def grad_check(torch, model, cfg, log):
    """L1's fp32 check at GRAD_CHECK_B x GRAD_CHECK_S: the loss and every
    parameter's gradient through B8 + B8ᵀ against ``force_ref=True``."""
    import numpy as np

    from repro_torch.data.synthetic import zipf_tokens
    from repro_torch.kernels import slstm as slstm_mod
    from repro_torch.models import make_loss_fn

    cfg32 = cfg.with_overrides(dtype="float32")
    toks = torch.as_tensor(zipf_tokens(np.random.RandomState(3), (
        GRAD_CHECK_B, GRAD_CHECK_S + 1), cfg.vocab_size), device="cuda")
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    out = {}
    for force_ref in (False, True):
        before = slstm_mod.backward_launches
        loss, _ = make_loss_fn(cfg32, force_ref=force_ref)(model, batch)
        loss.backward()
        out[force_ref] = (loss.item(), {k: p.grad for k, p in
                                        model.named_parameters()})
        for p in model.parameters():
            p.grad = None
        n_slstm = sum(b.block_type == "slstm" for b in model.layers)
        check(slstm_mod.backward_launches - before
              == (0 if force_ref else n_slstm),
              f"L1 grad check: {slstm_mod.backward_launches - before} "
              f"B8ᵀ launches with force_ref={force_ref}")
    (l_k, g_k), (l_p, g_p) = out[False], out[True]
    loss_rel = abs(l_k - l_p) / abs(l_p)
    check(loss_rel <= GRAD_LOSS_RTOL, f"L1 grad check: loss {l_k} vs {l_p}")
    rels = {k: rel_l2(g_k[k], g_p[k]) for k in g_p}
    worst = max(rels, key=rels.get)
    check(rels[worst] <= GRAD_REL_L2,
          f"L1 grad check: {worst} relative L2 {rels[worst]}")
    sl = [k for k in rels if ".slstm." in k]
    res = {"grad_check": f"{GRAD_CHECK_B} x {GRAD_CHECK_S} fp32",
           "loss_kernel": l_k, "loss_plain": l_p, "loss_rel": loss_rel,
           "grad_rel_l2_max": rels[worst], "grad_rel_l2_worst": worst,
           "grad_rel_l2_slstm_max": max(rels[k] for k in sl),
           "n_params_checked": len(rels)}
    log({"train": "L1 grad check", **res})
    return res


def set_allocator(torch, conf: str) -> None:
    """The caching allocator's settings from here on (as
    PYTORCH_CUDA_ALLOC_CONF would set them at start)."""
    setter = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    if setter is None:
        setter = torch.cuda.memory._set_allocator_settings
    setter(conf)


def compress_run(torch, cfg, log):
    """L2's two ``grad_compress`` steps at TRAIN_B x TRAIN_S, with
    COMPRESS_ALLOC's expandable segments: finite losses; the peak GiB."""
    from repro_torch.launch.train import train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    set_allocator(torch, COMPRESS_ALLOC)
    try:
        t0 = time.perf_counter()
        out = train(cfg, steps=2, global_batch=TRAIN_B, seq_len=TRAIN_S,
                    lr=TRAIN_LR, grad_compress=True, device="cuda")
        losses = [m["loss"] for m in out["metrics"]]
        del out
        res = {"losses": losses, "batch": TRAIN_B, "seq": TRAIN_S,
               "allocator": COMPRESS_ALLOC,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "seconds": time.perf_counter() - t0}
    finally:
        torch.cuda.empty_cache()
        set_allocator(torch, COMPRESS_ALLOC.replace("True", "False"))
    check(len(losses) == 2 and all(
        map(lambda x: x == x and abs(x) != float("inf"), losses)),
        f"L2 grad_compress: losses {losses}")
    log({"train": "L2 grad_compress", **res})
    return res


def run_training(torch, counters, log):
    """Phase L: training at full width through ``launch.train.train``: L1
    xlstm-1.3b (B8's saving entry + B8ᵀ), then its fp32 gradient check; L2
    qwen2-1.5b, 2 steps with ``grad_compress``, and the kill and resume at
    RESUME_LAYERS layers."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train

    from repro_torch.kernels import slstm

    res = {"phase": "L", "reduced": []}
    cfg = get_config(XLSTM)
    before = dict(slstm.backward_path_launches)
    l1, out = train_run(torch, cfg, "L1 xlstm-1.3b", counters,
                        log)
    res["launches"] = l1.pop("launches")
    n_slstm = sum(bt == "slstm" for bt in cfg.block_pattern) * cfg.n_units
    # B8ᵀ's path at xlstm-1.3b's head width (512): every launch a cluster one
    l1["slstm_backward_paths"] = {
        k: v - before[k] for k, v in slstm.backward_path_launches.items()}
    check(l1["slstm_backward_paths"] == {"cluster": n_slstm * TRAIN_STEPS,
                                         "l2": 0},
          f"L1: B8ᵀ's paths {l1['slstm_backward_paths']}")
    # the forward and the remat recompute each run B8 once a layer and step,
    # the backward B8ᵀ once
    check(res["launches"]["slstm"] == 2 * n_slstm * TRAIN_STEPS,
          f"L1: slstm launched {res['launches']['slstm']} times")
    check(res["launches"]["slstm_backward"] == n_slstm * TRAIN_STEPS,
          f"L1: slstm_backward launched "
          f"{res['launches']['slstm_backward']} times")
    res["L1"] = l1
    # the placed state at world 1 on a (1, 1) mesh: every tensor whole
    from repro_torch.models.model import placement_summary
    st = out["state"]
    pl = st.model.placement
    res["placement"] = {**placement_summary(st.model, st.opt),
                        "collectives": dict(pl.counts)}
    check(res["placement"]["param_bytes"]
          == res["placement"]["whole_param_bytes"]
          and res["placement"]["sharded_tensors"] == 0,
          f"L1: the (1, 1) placement holds {res['placement']}")
    log({"placement": "L1 " + XLSTM, **res["placement"]})
    model = st.model
    del out, st
    torch.cuda.empty_cache()
    res["L1"].update(grad_check(torch, model, cfg, log))
    del model
    torch.cuda.empty_cache()

    cfg = get_config(QWEN2)
    res["L2"], out = train_run(torch, cfg, "L2 qwen2-1.5b",
                                 counters, log)
    del out
    torch.cuda.empty_cache()
    res["L2"]["grad_compress"] = compress_run(torch, cfg, log)

    small = cfg.with_overrides(n_layers=RESUME_LAYERS)
    res["reduced"].append(
        f"L2 kill and resume: n_layers {cfg.n_layers} -> {RESUME_LAYERS}, "
        f"{RESUME_B} x {RESUME_S} tokens a step: a generation holds params, "
        f"m and v in fp32, 17.2 GiB at 28 layers, 3.65 GiB at "
        f"{RESUME_LAYERS}")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        kw = dict(steps=4, global_batch=RESUME_B, seq_len=RESUME_S,
                  ckpt_dir=ckpt, checkpoint_every=2, lr=TRAIN_LR,
                  device="cuda")
        try:
            train(small, simulate_failure_at=3, **kw)
            check(False, "L2 resume: the simulated failure did not raise")
        except RuntimeError as e:
            check("simulated node failure" in str(e), f"L2 resume: {e}")
        out = train(small, **kw)
        steps = [m["step"] for m in out["metrics"]]
        check(out["start_step"] == 2 and steps == [3, 4],
              f"L2 resume: started at {out['start_step']}, steps {steps}")
        from repro_torch.checkpoint import CheckpointStore
        last = os.path.join(ckpt, f"gen-{CheckpointStore(ckpt).latest():06d}")
        gen_bytes = sum(os.path.getsize(os.path.join(last, f))
                        for f in os.listdir(last))
        res["L2"]["resume"] = {"start_step": out["start_step"],
                               "steps": steps,
                               "generation_gib": gen_bytes / 2**30,
                               "seconds": time.perf_counter() - t0}
        del out
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    log({"phase_result": res})
    return res


# phase N: the dry run (``repro_torch.launch.dryrun``) on the host's CPU
# beside phases A-L: these archs at every shape on the single-pod
# production mesh, base and opt, and the six quantixar-db cells
N_ARCHS = ("qwen2-1.5b", "xlstm-1.3b")
N_CELLS = 4 * len(N_ARCHS) + 6
# phase L2's own cell for the dry run's peak (L2's settings, a (1, 1) mesh)
N_L2_CELL = {"arch": QWEN2, "kind": "train", "batch": TRAIN_B,
             "seq": TRAIN_S, "mesh": [1, 1], "variant": "base"}
# the card's peak over the dry run's for the same cell
N_PEAK_RATIO = (0.8, 1.2)


def start_dryrun():
    """Phase N's child processes, started now: the dry run of N_ARCHS and
    the db cells on ``pod16x16`` in each variant (into OUT_DIR/dryrun),
    and its prediction of phase L2's cell.  {name: (process, log path)}.
    They run niced, on the upper half of the cores this process may use
    (the lower half is left to the phases' own host work)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cpus = sorted(os.sched_getaffinity(0))
    upper = cpus[len(cpus) // 2:] or cpus

    def below():
        os.nice(10)
        os.sched_setaffinity(0, upper)
    base = [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun"]
    cmds = {v: base + ["--arch", ",".join(N_ARCHS), "--mesh", "single",
                       "--db", "--variant", v,
                       "--out", os.path.join(OUT_DIR, "dryrun")]
            for v in ("base", "opt")}
    cmds["L2"] = base + ["--predict", json.dumps(N_L2_CELL)]
    procs = {}
    for name, cmd in cmds.items():
        path = os.path.join(OUT_DIR, f"dryrun_{name}.log")
        with open(path, "w") as f:
            procs[name] = (subprocess.Popen(cmd, stdout=f,
                                            stderr=subprocess.STDOUT,
                                            env=env, cwd=ROOT,
                                            preexec_fn=below), path)
    return procs


def stop_dryrun(procs) -> None:
    for p, _ in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def run_dryrun(procs, l2, counters, log):
    """Phase N (i) and (ii): wait for the dry run, hold every record of
    its cells to ok or the reference's skip, and print its peak for L2's
    cell beside the card's (``l2``: phase L2's result).  The dry run runs
    on meta tensors in its own processes: this process's kernels launch no
    time (``launches``, read around the wait)."""
    counters.reset()
    t0 = time.perf_counter()
    codes = {name: p.wait() for name, (p, _) in procs.items()}
    res = {"phase": "N", "wait_s": time.perf_counter() - t0,
           "exit_codes": codes, "cells": {}, "launches": counters.read()}
    for name in ("base", "opt"):
        with open(procs[name][1]) as f:
            tail = f.read().splitlines()[-3:]
        check(codes[name] == 0, f"N: the dry run ({name}) exited "
              f"{codes[name]}: {tail}")
    tag_dir = os.path.join(OUT_DIR, "dryrun", "pod16x16")
    for fn in sorted(os.listdir(tag_dir)):
        with open(os.path.join(tag_dir, fn)) as f:
            rec = json.load(f)
        check(rec.get("ok") is True, f"N: {fn}: {rec.get('error')}")
        res["cells"][rec["cell"]] = (
            {"skipped": rec["skipped"]} if "skipped" in rec else
            {k: rec.get(k) for k in ("peak_gib", "fits_80gb", "wall_s",
                                     "aten_flops", "kernel_operations",
                                     "model_flops")}
            | {"collective_bytes": sum(rec["collectives"].get(k, 0) for k in
                                       ("gather_bytes", "reduce_bytes"))})
    check(len(res["cells"]) == 2 * N_CELLS,
          f"N: {len(res['cells'])} dry-run records, not {2 * N_CELLS}")
    with open(procs["L2"][1]) as f:
        pred = json.loads(f.read().strip().splitlines()[-1])
    check(pred.get("ok") is True, f"N: L2's cell: {pred.get('error')}")
    ratio = l2["peak_gib"] / pred["peak_gib"]
    res["L2_peak"] = {"card_gib": l2["peak_gib"],
                      "dryrun_gib": pred["peak_gib"], "ratio": ratio,
                      "dryrun_wall_s": pred["wall_s"],
                      "dryrun_state_and_input_gib":
                      pred["state_and_input_bytes"] / 2**30}
    log({"dryrun_peak": "N L2 " + QWEN2, **res["L2_peak"]})
    check(N_PEAK_RATIO[0] <= ratio <= N_PEAK_RATIO[1],
          f"N: L2's card peak over the dry run's {ratio}")
    log({"phase_result": res})
    return res


class Counters:
    """The kernels' launch counters, read as deltas since the last reset."""

    def __init__(self):
        from repro_torch.kernels import (beam_gather, beam_gather_adc,
                                         beam_gather_hamming, bulk_prune,
                                         hamming, l2, pq_adc, slstm)
        # name -> (wrapper module, its counter)
        self.mods = {"beam_gather": (beam_gather, "launches"),
                     "pair_gather": (bulk_prune, "launches"),
                     "beam_gather_adc": (beam_gather_adc, "launches"),
                     "beam_gather_hamming": (beam_gather_hamming, "launches"),
                     "beam_gather_hamming_masked": (beam_gather_hamming,
                                                    "masked_launches"),
                     "pq_adc": (pq_adc, "launches"),
                     "hamming": (hamming, "launches"),
                     "l2_distance": (l2, "launches"),
                     "l2_topk": (l2, "topk_launches"),
                     "beam_gather_lists": (beam_gather, "lists_launches"),
                     "slstm": (slstm, "launches"),
                     "slstm_backward": (slstm, "backward_launches")}

    def reset(self):
        for m, attr in self.mods.values():
            setattr(m, attr, 0)

    def read(self):
        return {k: getattr(m, attr) for k, (m, attr) in self.mods.items()}


def main(argv) -> int:
    kernels_only = argv == ["--kernels"]
    if argv and not kernels_only:
        print("usage: chip_smoke.py [--kernels]", file=sys.stderr)
        return 2
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
    dryrun = {}     # phase N's child processes, once phase 1 is timed
    try:
        from repro_torch.data.synthetic import fashion_mnist_like, sift_like
        from repro_torch.kernels import _build
        sys.path.insert(0, os.path.join(ROOT, "scripts"))
        import hamming_stage_cycles

        t0 = time.perf_counter()
        # B4's stage-split library builds beside the kernels
        stage_build = hamming_stage_cycles.start_build()
        built = _build.build()
        stage_lib = hamming_stage_cycles.finish_build(stage_build)
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
        # phase I's quantizers: these ones' state
        quant_state = {"pq": pq.state_dict(), "bq": bq.state_dict()}
        log({"quantizers_s": time.perf_counter() - t0})
        rows = kernel_checks(torch, [(128, sift_cos, ("dot",)),
                                     (128, sift_raw, ("l2",)),
                                     (784, fm_dev, ("l2", "dot")),
                                     (BQ_BITS, signs, ("dot",))], log)
        rows += quant_kernel_checks(torch, codes, lut, words, q_words, log,
                                    stage_lib)
        rows += l2_kernel_checks(torch, sift_cos, sift_raw, fm_dev, signs,
                                 log)
        if kernels_only:
            # phase 1 alone (B1-B7; B8 needs phase F's model): one line a
            # row with the shapes and times, then the card
            keys = ("name", "mode", "Q", "L", "B", "C", "D", "N", "k",
                    "row0_frac", "path", "stage", "layout", "threads",
                    "w8_layout", "fresh_share", "pad_share",
                    "ms", "call_ms", "plain_ms", "plain_call_ms",
                    "library_ms", "bound_ms", "bound_by", "share",
                    "max_abs_err", "digest")
            for r in rows:
                print(json.dumps({k: r[k] for k in keys if k in r},
                                 default=float))
            print(card)
            return 0
        dryrun.update(start_dryrun())
        topk_k_sweep(torch, sift_cos, sift_raw, log)
        small_topk_sweep(torch, {"raw": sift_raw, "unit": sift_cos,
                                 "signs": signs}, log)
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
        rows.append(phase["D"]["fused_step"])
        phase["E"] = run_api(torch, sift, sift_q, gt_sift, sift_new,
                             phase["A"], counters, log)
        phase["G"] = run_ivf(torch, sift, sift_q, gt_sift, sift_new,
                             counters, log)
        phase["H"] = run_cluster(torch, sift, sift_q, gt_sift, counters,
                                 log)
        phase["I"] = run_distributed(torch, sift, sift_q, quant_state,
                                     counters, log)
        del sift, sift_q, sift_new, fm, fm_q, fm_new, gt_sift, gt_fm
        torch.cuda.empty_cache()
        phase["F"], slstm_rows = run_xlstm(torch, counters, log)
        rows += slstm_rows
        phase["J"] = run_qwen2(torch, counters, log)
        phase["K"] = run_families(torch, counters, log)
        phase["L"] = run_training(torch, counters, log)
        phase["N"] = run_dryrun(dryrun, phase["L"]["L2"], counters, log)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        stop_dryrun(dryrun)
        log_f.close()
        import torch.distributed as dist
        if dist.is_initialized():       # phases I and L's world-1 group
            dist.destroy_process_group()

    def strip_row(r):
        if isinstance(r, list):
            return [strip_row(x) for x in r]
        return {k: v for k, v in r.items() if k not in ("name", "inputs")}

    def pick(name, **shape):
        return next(r for r in rows if r["name"] == name
                    and all(r.get(k) == v for k, v in shape.items()))

    # the line reports each kernel at its main path's dominant shape:
    # ms is the device time (`device_ms`), call_ms the per-call time with
    # the host (`time_ms`); beam_gather at the stitch's (Q=1024,
    # L=width 8 * M0 32=256, cosine) gathers, where A runs most of its
    # launches (L=128, search's, is in the log), the other gathers at
    # search's (Q=1024, L=width*M0=128),
    # the coarse prune's (B=4096, C=60) pair matrices, and the flat route's
    # Q=1024 against one 65,536-row chunk; the full sweep is in the log.
    # launches: the count in the phase whose path the kernel serves first
    # (A for the unquantized kernels, C for PQ, D for BQ), and per phase.
    # library_ms: embedding_bag for pq_adc and cdist(p=0) for hamming
    # (quant_kernel_checks), addmm for l2_distance in dot mode
    # (l2_kernel_checks); null for the four gathers, since no single
    # PyTorch call fuses a row gather with its distance, pair matrix, LUT
    # sum or bit count.  l2_distance's launches: phase E (its k = 1,000
    # query), at that query's shape (Q=32 x one 65,536-row chunk, dot)
    # against addmm; l2_topk, B5's fused entry, at phase E's batch (Q=1024
    # x the 1M corpus, cosine, k=10), launches in phase E (every exact
    # scan), with route_ms (the chunked matrix route it replaced) and
    # library_ms null; both with bound_ms held to 3xTF32 and bound_fp32_ms
    # beside it.  slstm: the full-width bf16 call (B=8, S=2,048) of phase
    # F's prefill, launches counted over one prefill; library_ms null,
    # since no PyTorch call computes its cell (slstm_kernel_checks).
    # beam_gather_hamming: the TPU function's entry at search's shape (the
    # kernel's launches in D, which all go through its fused entry:
    # launches_by_entry splits them); beam_gather_hamming_masked, its fused
    # entry, on four of D's own search steps (fused_step_row), with the
    # kernel's device ms in one D batch (in_path_ms).  beam_gather's entry
    # also carries its rows at IVF's shape, from phase G's own candidates
    # (at_ivf: Q=1024 x L=46,880, l2; the plain version on 64 queries) and
    # its list-major entry's on the same batches (at_ivf_lists, also its
    # own row, beam_gather_lists, with B1's b1_ms beside it: G runs B1
    # through that entry only; its bound_ms counts the live slots only,
    # bound_b1_ms is B1's at the same shape); l2_topk's its rows on G's coarse probes
    # (at_ivf_probe: Q=1024 x the 1,024 centroids, l2, k=nprobe=32, with
    # route_ms, the matrix route flat_search takes there) and on one of H's
    # shards (at_shard: Q=1024 and 32 x ~250k unit rows, cosine, k=10).
    # pq_adc, hamming and l2_distance also carry their rows where phase
    # I's "dims" ranks run them (at_dims_split: Q=1024 x a 65,536-row chunk
    # of a rank's half, m=8 / W=4 / D=64 in dot mode, the last over the
    # cosine rows and over l2's raw rows).
    main_rows = {
        "beam_gather": (pick("beam_gather", mode="dot", D=128, L=256), "A",
                        "beam_gather.py:98",
                        {"at_ivf": phase["G"]["b1_row"],
                         "at_ivf_lists": phase["G"]["lists_row"]}),
        "beam_gather_lists": (phase["G"]["lists_row"], "G",
                              "beam_gather.py:98"),
        "pair_gather": (pick("pair_gather", mode="dot", D=128, C=60,
                             row0_frac=0.0), "A",
                        "bulk_prune.py:47"),
        "beam_gather_adc": (pick("beam_gather_adc", L=128), "C",
                            "beam_gather.py:148"),
        "beam_gather_hamming": (pick("beam_gather_hamming", L=128), "D",
                                "beam_gather.py:185"),
        "beam_gather_hamming_masked": (phase["D"]["fused_step"], "D",
                                       "beam_gather.py:185"),
        "pq_adc": (pick("pq_adc", Q=QUERY_BATCH, N=FLAT_CHUNK, m=PQ_M), "C",
                   "pq_adc.py:59",
                   {"at_dims_split": phase["I"]["pq_row"]}),
        "hamming": (pick("hamming", N=FLAT_CHUNK, W=BQ_BITS // 32), "D",
                    "hamming.py:33",
                    {"at_dims_split": phase["I"]["hamming_row"]}),
        "l2_distance": (pick("l2_distance", mode="dot", D=128, Q=32,
                             N=FLAT_CHUNK), "E", "l2.py:62",
                        {"at_dims_split": phase["I"]["l2_rows"]}),
        "l2_topk": (next(r for r in rows if r["name"] == "l2_topk"
                         and "route_ms" in r and r["Q"] == QUERY_BATCH),
                    "E", "l2.py:62",
                    {"at_ivf_probe": phase["G"]["probe_row"],
                     "at_shard": phase["H"]["shard_rows"]}),
        "slstm": (pick("slstm", dtype="bfloat16", S=PREFILL_S), "F",
                  "slstm.py:90"),
        "slstm_backward": (pick("slstm_backward", dtype="bfloat16",
                                S=PREFILL_S), "L", "slstm.py:90")}
    # B8ᵀ replaces no TPU kernel: the reference differentiates a lax.scan of
    # its cell; it is the backward of B8's
    notes = {"slstm_backward": "no TPU kernel: the backward of B8 "
                               "(slstm.py:90); the JAX package trains "
                               "through autodiff of a lax.scan"}
    kernels = []
    for name, (r, home, tpu, *extra) in main_rows.items():
        entries = ENTRIES.get(name, (name,))

        def count(p, entries=entries):
            return sum(phase[p]["launches"][e] for e in entries)

        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/"
                      f"{SOURCES.get(name, name)}.cu",
            "replaces": f"src/repro/kernels/{tpu}",
            **({"replaces_note": notes[name]} if name in notes else {}),
            "launches": count(home),
            "launches_by_phase": {p: count(p) for p in phase},
            **({"launches_by_entry": {e: phase[home]["launches"][e]
                                      for e in entries}}
               if len(entries) > 1 else {}),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            **{k: r[k] for k in ("call_ms", "plain_call_ms",
                                 "library_call_ms", "bound_fp32_ms",
                                 "bound_b1_ms", "share_b1", "b1_ms",
                                 "route_ms",
                                 "path", "floor_ms", "digest",
                                 "in_path_ms", "in_path_launches",
                                 "fresh_share", "share", "rel_l2",
                                 "bound_bytes_ms", "forward_path")
               if k in r},
            "at": {k: r[k] for k in ("mode", "dtype", "Q", "L", "B", "C",
                                     "D", "N", "m", "k", "W", "S", "d", "H")
                   if k in r},
            # the kernel again where G and H run it
            **{key: strip_row(v) for key, v in
               (extra[0].items() if extra else ())}})
    summary = {
        "seconds": time.perf_counter() - t_start,
        **{p["phase"]: {k: p.get(k) for k in (
            "build_s", "qps", "recall_at_10", "ef_sweep",
            "mask_0.5_recall_at_10", "mask_0.05_recall_at_10",
            "quantize_peak_gb", "build_peak_gb")}
           for p in phase.values() if p["phase"] in "ABCD"},
        **{p: {k: v for k, v in phase[p].items()
               if k != "launches" and k not in ROW_KEYS}
           for p in ("E", "F", "G", "H", "I", "J", "K", "L", "N")}}
    print(json.dumps({"summary": summary}, default=float))
    print(card)
    print(json.dumps({"kernels": kernels}, default=float))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
