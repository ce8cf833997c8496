#!/usr/bin/env python3
"""Where B4 ``beam_gather_hamming``'s time goes: its device time stage by
stage, and its wrapper's host time part by part.

Builds a library under ``build/hamming_stage_cycles/`` that includes
``src/repro_torch/csrc/beam_gather_hamming.cu`` as it stands and adds
stage kernels beside it, then times each with ``chip_smoke.py``'s
``device_ms`` (CUDA events around a CUDA graph of ~20 ms of launches over
4 sets of random ids, over the count) at Q = 1,024, W = 8 (256-bit codes)
against ``--n`` random code rows (1M: 32 MB, L2-resident, as
``chip_smoke.py`` times B4), for L in {1, 128, 256}:

  empty   a kernel that does nothing, on the layout's grid and block: the
          launch and dispatch floor;
  ids     each pair's id loaded and stored: the first round trip;
  ids_q   the id and the query's words loaded, one store: the loads that
          can be in flight together (flat layout only);
  full    the kernel itself: ``beam_gather_hamming_u32`` (the C entry, as
          the wrapper calls it) and, where the source has the flat-grid
          launcher ``launch_pairs``, the TPU-function entry and the masked
          entry (a mask fresh on half of the slots, int64 ids) at
          each W = 8 layout (``w8_layout`` 1: a lane a pair, 2: two lanes
          a row, 4: four pairs a lane; see the source) and 128 / 256 / 512
          threads a block, and the TPU-function entry again with its rows
          read by ``__ldcg`` (L2 only) where the source reads them by
          ``__ldg``.

Layouts: ``grid2d`` is the (Q, ceil(L / 128)) grid of 128-thread blocks,
one block row per query; ``flat`` runs ceil(Q * L / threads) blocks over
the flat (query, slot) pairs, one thread a pair (the empty, ids and ids_q
stages; the full kernel's layout 4 takes a quarter of the blocks).

Then, at L = 128, the host time of one wrapper call by part (host clock
over 500 calls each, after 100, few enough that the launch queue never
fills): the checks, ``torch.empty``, entering the device context and
reading the current stream as a ``Stream`` object, reading the raw stream
handle, the ctypes call, ``_launch.launch`` as the tree has it, and the
whole wrapper.  Run on a card from the repository root:

    python3 scripts/hamming_stage_cycles.py [--n 1000000]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

Q, W = 1024, 8
FRESH = 0.5              # the masked entry's share of fresh slots
LENGTHS = (1, 128, 256)
FLAT = [(t, layout) for t in (128, 256, 512) for layout in (1, 2, 4)]
STAGES = {"empty": 0, "ids": 1, "ids_q": 2, "full": 3, "full_masked": 4}

STAGE_SRC = r"""
#include "@SRC@"

namespace stage {

__global__ void empty_kernel() {}

__global__ void ids_grid2d(const int* __restrict__ ids, int* __restrict__ out,
                           int L) {
  const int l = blockIdx.y * 128 + threadIdx.x;
  if (l >= L) return;
  const size_t i = static_cast<size_t>(blockIdx.x) * L + l;
  out[i] = __ldg(ids + i);
}

__global__ void ids_flat(const int* __restrict__ ids, int* __restrict__ out,
                         long long pairs) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (p < pairs) out[p] = __ldg(ids + p);
}

__global__ void ids_q_flat(const int* __restrict__ ids,
                           const uint4* __restrict__ q, int* __restrict__ out,
                           long long pairs, int L) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (p >= pairs) return;
  const int id = __ldg(ids + p);
  const unsigned qi = static_cast<unsigned>(p) / static_cast<unsigned>(L);
  const uint4 a = __ldg(q + qi * 2), b = __ldg(q + qi * 2 + 1);
  out[p] = id ^ (__popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w)
                 + __popc(b.x) + __popc(b.y) + __popc(b.z) + __popc(b.w));
}

#if HAS_FLAT
// the W = 8 layouts tried beside the source's (a thread a pair):
// two lanes a row -- a warp takes 32 consecutive pairs, lane l loads pair
// l's id, then for rows j and 16 + j (j = l / 2) the 16-byte half l % 2 of
// the row and of its query, ids passed by shuffle, so each row load reads
// 16 whole rows (one request a row, not two); the halves' counts meet by
// shuffle and lane l stores pair l
template <typename IdT, bool kMasked, int kThreads>
__global__ void __launch_bounds__(kThreads)
half_rows(const uint32_t* __restrict__ q, const IdT* __restrict__ ids,
          const uint8_t* __restrict__ fresh,
          const uint32_t* __restrict__ codes,
          typename Out<kMasked>::type* __restrict__ out, long long pairs,
          int L, int N) {
  const unsigned kFull = 0xffffffffu;
  const uint4* q4 = reinterpret_cast<const uint4*>(q);
  const uint4* x4 = reinterpret_cast<const uint4*>(codes);
  const long long t = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const int lane = threadIdx.x & 31, half = lane & 1, j = lane >> 1;
  const long long p0 = t - lane;
  const bool live = t < pairs;
  const long long p = live ? t : pairs - 1;
  long long id = static_cast<long long>(__ldg(ids + p));
  int use = 1;
  if constexpr (kMasked) use = __ldg(fresh + p);
  uint4 qv[2];
  for (int i = 0; i < 2; ++i) {
    const long long pi = min(p0 + 16 * i + j, pairs - 1);
    qv[i] = __ldg(q4 + 2 * query_of(pi, L, pairs) + half);
  }
  id = min(max(id, 0ll), static_cast<long long>(N) - 1);
  int acc[2];
  for (int i = 0; i < 2; ++i) {
    const long long r = __shfl_sync(kFull, id, 16 * i + j);
    const int u = __shfl_sync(kFull, use, 16 * i + j);
    acc[i] = u ? popc4(__ldg(x4 + 2 * r + half), qv[i]) : 0;
  }
  for (int i = 0; i < 2; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], 1);
  const int a0 = __shfl_sync(kFull, acc[0], 2 * (lane & 15));
  const int a1 = __shfl_sync(kFull, acc[1], 2 * (lane & 15));
  const int acc_p = lane < 16 ? a0 : a1;
  if (!live) return;
  if constexpr (kMasked)
    out[p] = use ? static_cast<float>(acc_p) : __int_as_float(0x7f800000);
  else
    out[p] = acc_p;
}

// four consecutive pairs a thread (Q * L % 4 == 0, aligned vectors): the
// ids in one or two 16-byte loads, the mask in one 4-byte load, eight row
// loads in flight, one 16-byte store; a quarter of the threads
template <typename IdT, bool kMasked, int kThreads>
__global__ void __launch_bounds__(kThreads)
four_pairs(const uint32_t* __restrict__ q, const IdT* __restrict__ ids,
           const uint8_t* __restrict__ fresh,
           const uint32_t* __restrict__ codes,
           typename Out<kMasked>::type* __restrict__ out, long long pairs,
           int L, int N) {
  const uint4* q4 = reinterpret_cast<const uint4*>(q);
  const uint4* x4 = reinterpret_cast<const uint4*>(codes);
  const long long p = 4 * (static_cast<long long>(blockIdx.x) * kThreads
                           + threadIdx.x);
  if (p >= pairs) return;
  long long row[4];
  if constexpr (sizeof(IdT) == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(ids + p));
    row[0] = v.x; row[1] = v.y; row[2] = v.z; row[3] = v.w;
  } else {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(ids + p));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(ids + p) + 1);
    row[0] = a.x; row[1] = a.y; row[2] = b.x; row[3] = b.y;
  }
  unsigned use = 0x01010101u;
  if constexpr (kMasked)
    use = __ldg(reinterpret_cast<const unsigned*>(fresh + p));
  uint4 qv[8];
  for (int k = 0; k < 4; ++k) {
    const long long qi = query_of(p + k, L, pairs);
    qv[2 * k] = __ldg(q4 + 2 * qi);
    qv[2 * k + 1] = __ldg(q4 + 2 * qi + 1);
  }
  int acc[4];
  for (int k = 0; k < 4; ++k) {
    const long long r = min(max(row[k], 0ll), static_cast<long long>(N) - 1);
    acc[k] = (use >> (8 * k)) & 0xff
        ? popc4(__ldg(x4 + 2 * r), qv[2 * k])
          + popc4(__ldg(x4 + 2 * r + 1), qv[2 * k + 1])
        : 0;
  }
  if constexpr (kMasked) {
    auto val = [&](int k) {
      return (use >> (8 * k)) & 0xff ? static_cast<float>(acc[k])
                                     : __int_as_float(0x7f800000);
    };
    *reinterpret_cast<float4*>(out + p) =
        make_float4(val(0), val(1), val(2), val(3));
  } else {
    *reinterpret_cast<int4*>(out + p) =
        make_int4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// the full kernel in W = 8 layout w8 (1: the source's launcher)
template <typename IdT, bool kMasked, int kThreads>
int run_full(int w8, const uint32_t* q, const IdT* ids, const uint8_t* fresh,
             const uint32_t* codes, typename Out<kMasked>::type* out, int Q,
             int L, int W, int N, cudaStream_t s) {
  const long long pairs = static_cast<long long>(Q) * L;
  if (w8 == 1)
    return (int)launch_pairs<IdT, kMasked, kThreads>(q, ids, fresh, codes,
                                                      out, Q, L, W, N, s);
  if (W != 8) return (int)cudaErrorInvalidValue;
  if (w8 == 2) {
    half_rows<IdT, kMasked, kThreads>
        <<<(unsigned)((pairs + kThreads - 1) / kThreads), kThreads, 0, s>>>(
            q, ids, fresh, codes, out, pairs, L, N);
  } else if (w8 == 4 && pairs % 4 == 0) {
    four_pairs<IdT, kMasked, kThreads>
        <<<(unsigned)((pairs / 4 + kThreads - 1) / kThreads), kThreads, 0,
           s>>>(q, ids, fresh, codes, out, pairs, L, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
#endif  // HAS_FLAT

template <int kThreads>
int run_flat(int stage, int w8, const uint32_t* q, const int* ids,
             const long long* ids64, const uint8_t* fresh,
             const uint32_t* codes, void* out, int Q, int L, int W, int N,
             cudaStream_t s) {
  const long long pairs = static_cast<long long>(Q) * L;
  const unsigned blocks =
      static_cast<unsigned>((pairs + kThreads - 1) / kThreads);
  switch (stage) {
    case 0: empty_kernel<<<blocks, kThreads, 0, s>>>(); break;
    case 1:
      ids_flat<<<blocks, kThreads, 0, s>>>(ids, (int*)out, pairs);
      break;
    case 2:
      ids_q_flat<<<blocks, kThreads, 0, s>>>(
          ids, reinterpret_cast<const uint4*>(q), (int*)out, pairs, L);
      break;
#if HAS_FLAT
    case 3:
      return run_full<int, false, kThreads>(w8, q, ids, nullptr, codes,
                                            (int32_t*)out, Q, L, W, N, s);
    case 4:
      return run_full<long long, true, kThreads>(w8, q, ids64, fresh, codes,
                                                 (float*)out, Q, L, W, N, s);
#endif
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace stage

// threads 0: the grid2d layout (stages 0 and 1)
extern "C" int stage_launch(int stage, int threads, int w8,
                            const uint32_t* q, const int* ids,
                            const long long* ids64, const uint8_t* fresh,
                            const uint32_t* codes, void* out, int Q, int L,
                            int W, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads == 0) {
    const dim3 grid(Q, (L + 127) / 128);
    if (stage == 0) stage::empty_kernel<<<grid, 128, 0, s>>>();
    else if (stage == 1) stage::ids_grid2d<<<grid, 128, 0, s>>>(ids, (int*)out, L);
    else return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  switch (threads) {
    case 128: return stage::run_flat<128>(stage, w8, q, ids, ids64, fresh,
                                          codes, out, Q, L, W, N, s);
    case 256: return stage::run_flat<256>(stage, w8, q, ids, ids64, fresh,
                                          codes, out, Q, L, W, N, s);
    case 512: return stage::run_flat<512>(stage, w8, q, ids, ids64, fresh,
                                          codes, out, Q, L, W, N, s);
  }
  return (int)cudaErrorInvalidValue;
}
"""


SOURCE = os.path.join(ROOT, "src", "repro_torch", "csrc",
                      "beam_gather_hamming.cu")


# the source's W = 8 row loads, and the same through L2 only
ROW_LOADS = "popc4(__ldg(x4), qa) + popc4(__ldg(x4 + 1), qb)"
ROW_LOADS_CG = "popc4(__ldcg(x4), qa) + popc4(__ldcg(x4 + 1), qb)"


def shipped_block():
    """Threads a block of the source's entries, or None where the source
    has no flat-grid launcher (the first kernel's (Q, L / 128) grid)."""
    with open(SOURCE) as f:
        text = f.read()
    found = re.search(r"constexpr int kBlock = (\d+);", text)
    if "launch_pairs" not in text or not found:
        return None
    return int(found.group(1))


def start_build(l2_only: bool = False):
    """Start nvcc on the stage library; returns the handle `finish_build`
    takes (so that a caller can build it beside the port's kernels).
    ``l2_only``: build it over a copy of the source whose W = 8 row loads
    are ``__ldcg`` (L2 only) in place of ``__ldg`` (an exact text edit,
    which must find its place)."""
    from repro_torch.kernels import _build

    has_flat = shipped_block() is not None
    out_dir = os.path.join(ROOT, "build", "hamming_stage_cycles")
    os.makedirs(out_dir, exist_ok=True)
    src, tag = SOURCE, ""
    if l2_only:
        with open(SOURCE) as f:
            text = f.read()
        if ROW_LOADS not in text:
            raise RuntimeError("hamming_stage_cycles: the source's W = 8 row "
                               "loads changed; update ROW_LOADS")
        src, tag = os.path.join(out_dir, "beam_gather_hamming_cg.cu"), "_cg"
        with open(src, "w") as f:
            f.write(text.replace(ROW_LOADS, ROW_LOADS_CG))
    cu = os.path.join(out_dir, f"hamming_stages{tag}.cu")
    with open(cu, "w") as f:
        f.write(STAGE_SRC.replace("@SRC@", src))
    so = os.path.join(out_dir, f"libhamming_stages{tag}.so")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    flags = [a for a in _build.NVCC_FLAGS if a not in ("-Xptxas", "-v")]
    proc = subprocess.Popen([nvcc, *flags, f"-DHAS_FLAT={int(has_flat)}",
                             "-o", so, cu], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, so


def finish_build(handle) -> ctypes.CDLL:
    proc, so = handle
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("hamming_stage_cycles: build failed\n" + log)
    lib = ctypes.CDLL(so)
    lib.stage_launch.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.stage_launch.restype = ctypes.c_int
    return lib


def stage_call(torch, lib, stage, threads, w8, q, ids, words, out,
               ids64=None, fresh=None):
    """One launch of ``stage`` (a key of STAGES) on the current stream;
    threads 0 is the grid2d layout.  Raises on a CUDA error."""
    (nq, w), length, n = q.shape, ids.shape[1], words.shape[0]
    err = lib.stage_launch(
        STAGES[stage], threads, w8, q.data_ptr(), ids.data_ptr(),
        None if ids64 is None else ids64.data_ptr(),
        None if fresh is None else fresh.data_ptr(), words.data_ptr(),
        out.data_ptr(), nq, length, w, n,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"hamming_stage_cycles: {stage} at {threads} x "
                           f"{w8}: CUDA error {err}")


def host_us(torch, fn, reps=500, warmup=100):
    """Host microseconds a call, over ``reps`` calls issued after the card
    has drained: few enough that the launch queue never fills, so the host
    clock reads the host's work alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("hamming_stage_cycles: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build, _launch, ref
    from repro_torch.kernels import beam_gather_hamming as bgh

    has_flat = shipped_block() is not None
    builds = [start_build()] + ([start_build(l2_only=True)] if has_flat
                                else [])
    lib, *cg_lib = [finish_build(b) for b in builds]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n = args.n
    words = torch.randint(-2 ** 31, 2 ** 31, (n, W), generator=gen,
                          device="cuda", dtype=torch.int32)
    qw = torch.randint(-2 ** 31, 2 ** 31, (Q, W), generator=gen,
                       device="cuda", dtype=torch.int32)
    entry = _launch.c_fn(_build.load("beam_gather_hamming"),
                         "beam_gather_hamming_u32", n_ptrs=4, n_ints=4)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def checked(err, what):
        if err:
            raise SystemExit(f"hamming_stage_cycles: {what}: CUDA error {err}")

    for length in LENGTHS:
        sets = []
        for _ in range(cs.SETS):
            ids = torch.randint(0, n, (Q, length), generator=gen,
                                device="cuda", dtype=torch.int32)
            fresh = torch.rand((Q, length), generator=gen,
                               device="cuda") < FRESH
            sets.append((ids, ids.long(), fresh))
        out = torch.empty((Q, length), dtype=torch.int32, device="cuda")
        ids, ids64, fresh = sets[0]
        checked(entry(qw.data_ptr(), ids.data_ptr(), words.data_ptr(),
                      out.data_ptr(), Q, length, W, n, stream()), "entry")
        want = ref.beam_gather_hamming_ref(qw, ids, words)
        if not torch.equal(out, want):
            raise SystemExit(f"hamming_stage_cycles: entry differs at "
                             f"L={length}")
        rows = [{"layout": "entry", "stage": "full", "ms": cs.device_ms(
            torch, [lambda s=s: checked(entry(
                qw.data_ptr(), s[0].data_ptr(), words.data_ptr(),
                out.data_ptr(), Q, length, W, n, stream()), "entry")
                for s in sets])}]
        # (layout, threads, w8, stages, library, row load)
        plans = [("grid2d", 0, 1, ("empty", "ids"), lib, None)]
        plans += [("flat", t, 1, ("empty", "ids", "ids_q"), lib, None)
                  for t in sorted({t for t, _ in FLAT})]
        if has_flat:
            plans += [("flat", t, w8, ("full", "full_masked"), lib,
                       "__ldg") for t, w8 in FLAT]
            plans += [("flat", t, 1, ("full",), cg_lib[0], "__ldcg")
                      for t in sorted({t for t, _ in FLAT})]
        for layout, threads, w8, stages, slib, load in plans:
            for stage in stages:
                def call(s, stage=stage, threads=threads, w8=w8,
                         slib=slib):
                    stage_call(torch, slib, stage, threads, w8, qw, s[0],
                               words, out, s[1], s[2])
                if stage.startswith("full"):
                    call(sets[0])
                    got = out if stage == "full" else out.view(torch.float32)
                    want = ref.beam_gather_hamming_ref(qw, ids, words)
                    if stage == "full_masked":
                        want = torch.where(fresh, want.float(), float("inf"))
                    if not torch.equal(got, want):
                        raise SystemExit(f"hamming_stage_cycles: {stage} "
                                         f"{threads}x{w8} differs at "
                                         f"L={length}")
                rows.append({"layout": layout, "threads": threads or 128,
                             "w8_layout": w8, "stage": stage,
                             **({"row_load": load} if load else {}),
                             "ms": cs.device_ms(torch, [
                                 lambda s=s: call(s) for s in sets])})
        for r in rows:
            print(json.dumps({"Q": Q, "L": length, "W": W, "N": n,
                              "fresh": FRESH, **r}), flush=True)

    # the wrapper's host time by part, at L = 128
    length = 128
    ids = torch.randint(0, n, (Q, length), generator=gen, device="cuda",
                        dtype=torch.int32)
    out = torch.empty((Q, length), dtype=torch.int32, device="cuda")
    dev = qw.device
    ptrs = (qw.data_ptr(), ids.data_ptr(), words.data_ptr(), out.data_ptr(),
            Q, length, W, n)
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)

    def checks():
        _launch.check_tensors("b4", q=qw, ids=ids, codes=words)
        _launch.check_dtypes("b4", q=(qw, torch.int32),
                             ids=(ids, torch.int32),
                             codes=(words, torch.int32))

    def context_stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    s0 = stream()
    parts = {
        "checks": host_us(torch, checks),
        "torch_empty": host_us(torch, lambda: torch.empty(
            (Q, length), dtype=torch.int32, device=dev)),
        "device_context_and_stream": host_us(torch, context_stream),
        "raw_stream": None if raw is None else host_us(
            torch, lambda: raw(torch.cuda.current_device())),
        "ctypes_call": host_us(torch, lambda: entry(*ptrs, s0)),
        "launch_helper": host_us(torch, lambda: _launch.launch(
            "b4", entry, dev, *ptrs)),
        "wrapper": host_us(torch, lambda: bgh.beam_gather_hamming(
            qw, ids, words)),
    }
    if hasattr(bgh, "beam_gather_hamming_masked"):
        ids64, fresh = ids.long(), torch.ones_like(ids, dtype=torch.bool)
        parts["masked_wrapper"] = host_us(
            torch, lambda: bgh.beam_gather_hamming_masked(qw, ids64, fresh,
                                                          words))
    print(json.dumps({"host_us_per_call": parts, "Q": Q, "L": length,
                      "shipped_block": shipped_block()}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
