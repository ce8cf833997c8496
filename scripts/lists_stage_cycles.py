#!/usr/bin/env python3
"""Where B1's list-major entries spend their device time, stage by stage,
on phase G's own batches.

Builds a library under ``<root>/build/lists_stage_cycles/`` that includes
``<root>/src/repro_torch/csrc/beam_gather.cu`` as it stands and adds stage
kernels beside it, then times each with ``chip_smoke.py``'s ``device_ms``
(CUDA events around a CUDA graph of ~20 ms of launches, cycling over the
batches, over the count).  The inputs are phase G's: an IVF engine over
``sift_like(1M)`` (cosine, nlist 1,024, nprobe 32) and the 10 batches of
1,024 of ``sift_like(10_000, seed=1)`` (the last of 784) at k = 10, each
batch's (queries, probe, lists, list_len, prepped corpus) kept as
``core/ivf.py`` hands them to the kernel.

The matrix entry ``beam_gather_lists`` (at D = 128, its wide tile: 32
queries, a two-stage ring of 64 rows, every tree where it exists):

  empty       a kernel that does nothing on the entry's grid, block and
              shared memory: the launch and dispatch floor;
  rows        each block's schedule and its ring's row copies (cp.async,
              the two barriers a stage), no arithmetic;
  rows_arith  the rows and every pair's arithmetic (B1's tree), no stores
              (a value is stored only where it equals a runtime NaN: never);
  fill        each block's schedule and its +inf fill past the live
              length, alone;
  full        the C entry ``beam_gather_lists_f32`` as the wrapper calls it.

The fused entry ``beam_gather_lists_topk`` (where the source has it: its
kernel's own ``kStage`` template parameter and ring depth, launched here
through its ``launch_topk``, no text edit):

  topk_empty       the schedule alone on the fused grid;
  topk_rows        the schedule and the bulk-copy ring (producer warp,
                   full / empty mbarriers), no arithmetic;
  topk_rows_arith  the rows and the arithmetic, no selection;
  topk_full        the C entry ``beam_gather_lists_topk_f32`` (k = 10) at
                   its own ring depth, the whole kernel at 2, 3 and 4
                   stages, and ``topk_wrapper``, the wrapper with its
                   schedule, merge and decode.

Before the rows, ptxas's registers and spills of every list-major kernel
the library holds (its ``-Xptxas -v`` lines).

Run on a card from the repository root, for this checkout or another tree
(the parent, unpacked with ``git archive``):

    python3 scripts/lists_stage_cycles.py [--root build/parent]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N, NQ, BATCH, NLIST, NPROBE, K = 1_000_000, 10_000, 1024, 1024, 32, 10

STAGES = {"empty": 0, "rows": 1, "rows_arith": 2, "fill": 3, "full": 4,
          "topk_empty": 5, "topk_rows": 6, "topk_rows_arith": 7,
          "topk_full": 8}

STAGE_SRC = r"""
#include "@SRC@"

namespace stage {

__global__ void empty_kernel() {}

// the matrix entry's wide-tile kernel (beam_gather_lists_kernel<4, 2,
// true, true, true>, D = 128) cut at a stage: 1 the schedule and the ring's
// row copies; 2 and the arithmetic, no stores; 3 the schedule and the
// +inf fill alone
template <int kStage>
__global__ void __launch_bounds__(kListThreads, 2)
lists_stage(const float* __restrict__ q, const int32_t* __restrict__ entries,
            const int32_t* __restrict__ starts,
            const int32_t* __restrict__ tile_end,
            const int32_t* __restrict__ lists,
            const int32_t* __restrict__ list_len,
            const float* __restrict__ corpus, float* __restrict__ out, int P,
            int M, int D, int N, int nlist, float never) {
  constexpr int A = kWideA, B = kWideB;
  constexpr int TQ = kListWarps * A;
  constexpr int TR = 32 * B;
  extern __shared__ float4 lists_smem4[];
  __shared__ int ent_s[TQ];
  const int blk = blockIdx.x;
  int lo = 0, hi = nlist;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tile_end[mid] > blk) hi = mid; else lo = mid + 1;
  }
  if (lo == nlist) return;
  const int lst = lo;
  const int first = starts[lst], count = starts[lst + 1] - first;
  const int t = blk - (tile_end[lst] - (count + TQ - 1) / TQ);
  const int ne = min(TQ, count - t * TQ);
  const int R = min(max(list_len[lst], 0), M);
  const int32_t* ids = lists + static_cast<size_t>(lst) * M;
  const int tid = threadIdx.x;
  const int stride = list_stride(D);
  float* q_s = reinterpret_cast<float*>(lists_smem4);
  float* ring = q_s + TQ * stride;
  const int n_stages = (R + TR - 1) / TR;
  if (kStage != 3 && n_stages > 0) {
    load_rows<true>(ring, ids, corpus, 0, min(TR, R), D, N, stride);
    cp_commit_group();
  }
  for (int i = tid; i < TQ; i += kListThreads)
    ent_s[i] = i < ne ? entries[first + t * TQ + i] : -1;
  __syncthreads();
  if (kStage == 3) {
    for (int e = 0; e < ne; ++e) {
      float* o = out + ent_s[e] * M;
      for (int r = R + tid; r < M; r += kListThreads) o[r] = plus_inf();
    }
    return;
  }
  if (n_stages == 0) return;
  for (int i = tid; i < TQ * D; i += kListThreads) {
    const int qt = i / D, d = i - qt * D;
    q_s[qt * stride + d] =
        qt < ne ? q[static_cast<size_t>(ent_s[qt] / P) * D + d] : 0.f;
  }
  const int warp = tid >> 5, lane = tid & 31;
  const float* qr[A];
  for (int a = 0; a < A; ++a) qr[a] = q_s + (warp * A + a) * stride;
  for (int s = 0; s < n_stages; ++s) {
    const int r0 = s * TR;
    float* stage = ring + (s & 1) * TR * stride;
    if (s + 1 < n_stages) {
      load_rows<true>(ring + ((s + 1) & 1) * TR * stride, ids, corpus,
                      r0 + TR, min(TR, R - r0 - TR), D, N, stride);
      cp_commit_group();
      cp_wait_group<1>();
    } else {
      cp_wait_group<0>();
    }
    __syncthreads();
    if (kStage == 2 && warp * A < ne) {
      const float* xr[B];
      for (int b = 0; b < B; ++b) xr[b] = stage + (lane + 32 * b) * stride;
      float res[A][B];
      pair_tile<A, B, true, true, true>(qr, xr, D, res,
                                        std::make_integer_sequence<int, 32>{});
      for (int a = 0; a < A; ++a)
        for (int b = 0; b < B; ++b)
          if (res[a][b] == never) out[0] = res[a][b];
    }
    __syncthreads();
  }
}

#if HAS_TOPK
// the fused entry's wide tile at D = 128 (k <= 32: one chunk of keys a
// warp) cut at its own kStage: 0 the schedule, 1 and the ring, 2 and the
// arithmetic, 3 the whole kernel, at ring depth `ring`; stage 3 at ring 0
// is the C entry itself (its depth, topk_ring's)
int topk_stage(int kstage, const float* q, const int32_t* entries,
               const int32_t* starts, const int32_t* tile_end,
               const int32_t* order, const int32_t* lists,
               const int32_t* list_len,
               const float* corpus, long long* cand, int Q, int P, int M,
               int D, int N, int nlist, int k, int ring, cudaStream_t s) {
  if (kstage == 3 && ring == 0)
    return beam_gather_lists_topk_f32(q, entries, starts, tile_end, order,
                                      lists, list_len, corpus, cand, Q, P, M,
                                      D, N, nlist, k, s);
  const int tq = topk_tile_q(D), tr = 32 * kWideB;
  const int kl = k < M ? k : M;
  const int rn = ring ? ring : topk_ring(tq, tr, D);
  const size_t smem = topk_smem(tq, tr, D, rn);
  if (D != 128 || tq != kListWarps * kWideA || kl > 32 || rn < 2 ||
      rn > kTopkMaxRing || smem > kListSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (Q * P + tq - 1) / tq + nlist;
#define TOPK_STAGE(n)                                                     \
  if (kstage == n)                                                        \
    return launch_topk<kWideA, kWideB, true, true, true, 1, n>(           \
        q, entries, starts, tile_end, order, lists, list_len, corpus, cand, \
        P, M, D, N, nlist, kl, rn, nb, smem, s);
  TOPK_STAGE(0)
  TOPK_STAGE(1)
  TOPK_STAGE(2)
  TOPK_STAGE(3)
#undef TOPK_STAGE
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif

}  // namespace stage

extern "C" int stage_launch(int stage, const float* q, const int32_t* entries,
                            const int32_t* starts, const int32_t* tile_end,
                            const int32_t* order, const int32_t* lists,
                            const int32_t* list_len,
                            const float* corpus, float* out,
                            long long* cand, int Q, int P, int M, int D,
                            int N, int nlist, int k, int ring,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage == 4)
    return beam_gather_lists_f32(q, entries, starts, tile_end, lists,
                                 list_len, corpus, out, Q, P, M, D, N, nlist,
                                 stream);
#if HAS_TOPK
  if (stage >= 5)
    return stage::topk_stage(stage - 5, q, entries, starts, tile_end, order,
                             lists, list_len, corpus, cand, Q, P, M, D, N,
                             nlist, k, ring, s);
#endif
  if (D != 128 || list_tile_q(D) != kListWarps * kWideA)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (Q * P + list_tile_q(D) - 1) / list_tile_q(D) + nlist;
  const size_t smem = list_smem(kListWarps * kWideA, 32 * kWideB, D);
  const float never = __builtin_nanf("");
  auto attr = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  };
  switch (stage) {
    case 0:
      attr(stage::empty_kernel);
      stage::empty_kernel<<<nb, kListThreads, smem, s>>>();
      break;
#define STAGE(n)                                                          \
    case n:                                                               \
      attr(stage::lists_stage<n>);                                        \
      stage::lists_stage<n><<<nb, kListThreads, smem, s>>>(               \
          q, entries, starts, tile_end, lists, list_len, corpus, out, P, M, \
          D, N, nlist, never);                                            \
      break;
    STAGE(1)
    STAGE(2)
    STAGE(3)
#undef STAGE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def source(root: str) -> str:
    return os.path.join(root, "src", "repro_torch", "csrc", "beam_gather.cu")


def has_topk(root: str) -> bool:
    with open(source(root)) as f:
        return "beam_gather_lists_topk_f32" in f.read()


def start_build(root: str):
    """Start nvcc on the stage library over ``root``'s source; returns the
    handle `finish_build` takes."""
    from repro_torch.kernels import _build

    out_dir = os.path.join(os.path.abspath(root), "build",
                           "lists_stage_cycles")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "lists_stages.cu")
    with open(cu, "w") as f:
        f.write(STAGE_SRC.replace("@SRC@", os.path.abspath(source(root))))
    so = os.path.join(out_dir, "liblists_stages.so")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    flags = list(_build.NVCC_FLAGS)
    proc = subprocess.Popen([nvcc, *flags, f"-DHAS_TOPK={int(has_topk(root))}",
                             "-o", so, cu], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, so


def kernel_resources(log: str):
    """{kernel: ptxas's resource lines} for the list-major kernels, from
    the build log's ``-Xptxas -v`` output (registers, spills)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("spill" in line or "registers" in line) and \
                "beam_gather_lists" in name:
            out.setdefault(name, []).append(line.split("ptxas info    :")[-1]
                                            .strip())
    return out


def finish_build(handle) -> ctypes.CDLL:
    proc, so = handle
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("lists_stage_cycles: build failed\n" + log)
    for name, lines in kernel_resources(log).items():
        print(json.dumps({"kernel": name, "ptxas": lines}), flush=True)
    lib = ctypes.CDLL(so)
    lib.stage_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 \
        + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.stage_launch.restype = ctypes.c_int
    return lib


def g_batches(torch, counters=None):
    """Phase G's engine and its 10 batches' kernel inputs: [(q, probe,
    lists, list_len, corpus)], as ``core/ivf.py`` hands them to whichever
    list-major entry the tree's card path runs."""
    from repro_torch.core import EngineConfig, IVFConfig, QuantixarEngine
    from repro_torch.data.synthetic import sift_like
    from repro_torch.kernels import ops

    cfg = EngineConfig(dim=128, metric="cosine", index="ivf",
                       ivf=IVFConfig(nlist=NLIST, nprobe=NPROBE))
    eng = QuantixarEngine(cfg)
    eng.add(sift_like(N, seed=0))
    eng.build()
    queries = sift_like(NQ, seed=1)
    calls = []
    names = [n for n in ("beam_gather_lists_distances",
                         "beam_gather_lists_topk") if hasattr(ops, n)]
    origs = {n: getattr(ops, n) for n in names}

    def keeper(name):
        def keep(q, probe, lists, list_len, corpus, *a, **kw):
            calls.append((q.float().contiguous(),
                          probe.to(torch.int32).contiguous(), lists,
                          list_len, corpus))
            return origs[name](q, probe, lists, list_len, corpus, *a, **kw)
        return keep

    for n in names:
        setattr(ops, n, keeper(n))
    try:
        for lo in range(0, NQ, BATCH):
            eng.search(queries[lo: lo + BATCH], K)
    finally:
        for n, f in origs.items():
            setattr(ops, n, f)
    torch.cuda.synchronize()
    n_batches = -(-NQ // BATCH)
    if len(calls) != n_batches:
        raise SystemExit(f"lists_stage_cycles: {len(calls)} kernel calls "
                         f"for {n_batches} batches")
    return eng, calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="the tree whose source and package are measured")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    import torch
    if not torch.cuda.is_available():
        print("lists_stage_cycles: needs a CUDA device", file=sys.stderr)
        return 2
    # the measured tree's package first; chip_smoke's timer from this one
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(root, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import beam_gather as bg

    handle = start_build(root)
    card = cs.card_line()
    print(card, flush=True)
    _, calls = g_batches(torch)
    lib = finish_build(handle)
    topk = has_topk(root)
    _, _, lists, list_len, corpus = calls[0]
    nlist, m = lists.shape
    d, n = corpus.shape[1], corpus.shape[0]
    tq = bg.tile_q(d)
    out = torch.empty((BATCH, NPROBE * m), dtype=torch.float32,
                      device="cuda")
    cand = torch.empty((BATCH, NPROBE, K), dtype=torch.int64, device="cuda")
    # the matrix entry's schedule takes the lists by id, the fused entry's
    # longest first
    order = bg.longest_first(list_len) if topk else None
    sched, topk_sched = [], []
    for q, probe, *_ in calls:
        sched.append((q, probe, *bg.list_tiles(probe, nlist, tq)))
        if topk:
            topk_sched.append((q, probe,
                               *bg.list_tiles(probe, nlist, tq, order)))

    def launch(stage, s, ring=0):
        q, probe, entries, starts, tile_end = s
        err = lib.stage_launch(
            STAGES[stage], q.data_ptr(), entries.data_ptr(),
            starts.data_ptr(), tile_end.data_ptr(),
            None if order is None else order.data_ptr(), lists.data_ptr(),
            list_len.data_ptr(), corpus.data_ptr(), out.data_ptr(),
            cand.data_ptr(), q.shape[0], NPROBE, m, d, n, nlist, K, ring,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"lists_stage_cycles: {stage}: CUDA error {err}")

    # the full stages must give the wrappers' outputs
    launch("full", sched[0])
    want = bg.beam_gather_lists(*calls[0])
    if not torch.equal(out, want):
        raise SystemExit("lists_stage_cycles: the matrix entry through the "
                         "stage library differs from its wrapper")
    base = {"Q": BATCH, "P": NPROBE, "M": m, "D": d, "N": n,
            "nlist": nlist, "tile_q": tq, "root": os.path.relpath(root, HERE),
            "batches": len(calls)}
    stages = [(st, 0) for st in ("empty", "rows", "rows_arith", "fill",
                                 "full")]
    if topk:
        # the C entry's keys, merged as the wrapper merges them, must be
        # the wrapper's output
        launch("topk_full", topk_sched[0])
        kl = min(K, m)
        keys = torch.topk(cand.view(BATCH, NPROBE * K)[:, :NPROBE * kl], K,
                          largest=False).values
        want_d, want_c = bg.beam_gather_lists_topk(*calls[0], K)
        if not torch.equal(keys & 0xFFFFFFFF, want_c):
            raise SystemExit("lists_stage_cycles: the fused entry through "
                             "the stage library differs from its wrapper")
        stages += [("topk_empty", 0), ("topk_rows", 0),
                   ("topk_rows_arith", 0)]
        stages += [("topk_full", r) for r in (0, 2, 3, 4)]
    for stage, ring in stages:
        r = {"stage": stage, **base,
             **({"ring": ring or "default"} if stage.startswith("topk")
                else {}),
             "ms": cs.device_ms(torch, [
                 lambda s=s, st=stage, rg=ring: launch(st, s, rg)
                 for s in (topk_sched if stage.startswith("topk")
                           else sched)])}
        print(json.dumps(r), flush=True)
    if topk:
        r = {"stage": "topk_wrapper", **base, "k": K,
             "ms": cs.device_ms(torch, [
                 lambda c=c: bg.beam_gather_lists_topk(*c, K)
                 for c in calls])}
        print(json.dumps(r), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
