#!/usr/bin/env python3
"""Where B5's cycles go inside the kernel, per consumer warp.

Builds an instrumented copy of ``src/repro_torch/csrc/l2_distance.cu`` under
``build/l2_stage_cycles/`` (clock64() around each step of the consumers'
loop, per-warp sums written to a device array), runs the matrix entry and
the fused entry (k = 1 and 10) at Q = 1,024 and Q = 32 against
``--n`` unit rows of width 128 in dot mode, and prints, per run, the mean
and the largest per-warp kcycles of:

  wait_full  waiting for a stage's loads;
  split      splitting a stage into big / small (and the norms);
  barrier    the consumers' named barrier after the split;
  mma_wait   waiting for a stage's products after the split;
  epilogue   the tile epilogues (matrix: the stores; fused: the filter and
             the insertions), and within the fused one filter and inserts;
  passes     the fused entry's insertion passes (lanes with survivors);
  total      the whole consumer loop.

The rest of total is issuing the stage's 12 wgmma (the issuing warp waits
while the tensor cores take them), the adds into the running sum and the
loop.  The instrumented copy is a measuring tool, not the port's kernel:
its times are stretched by the clock reads.  Run on a card from the
repository root:

    python3 scripts/l2_stage_cycles.py [--n 262144]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SLOTS = ("epilogue", "wait_full", "split", "barrier", "mma_wait", "total",
         "filter", "inserts", "passes")
MAX_BLOCKS = 4096


def instrument(src: str) -> str:
    """The kernel source with per-warp cycle counters: exact text edits,
    each of which must find its place."""
    edits = [
        ("namespace {\n\nconstexpr int kThreads",
         f"__device__ long long stage_cycles[{MAX_BLOCKS} * 8 * 9];\n"
         "extern \"C\" int stage_cycles_get(long long* out, int n) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, stage_cycles, n * 8);\n}\n"
         "namespace {\n\nconstexpr int kThreads"),
        ("  auto epilogue = [&](int t) {",
         "  long long c_epi = 0, c_wait = 0, c_split = 0, c_bar = 0, "
         "c_mma = 0, c_all = clock64(), c_fil = 0, c_ins = 0, c_np = 0;\n"
         "  auto epilogue = [&](int t) {"),
        ("      const int r0 = 64 * wg + 16 * warp + (lane >> 2);\n"
         "      const int c0",
         "      long long te = clock64();\n"
         "      const int r0 = 64 * wg + 16 * warp + (lane >> 2);\n"
         "      const int c0"),
        ("      unsigned pend = __ballot_sync(~0u, surv != 0);\n"
         "      float* buf",
         "      c_fil += clock64() - te;\n      long long tp = clock64();\n"
         "      unsigned pend = __ballot_sync(~0u, surv != 0);\n"
         "      c_np += __popc(pend);\n      float* buf"),
        ("        __syncwarp();\n        pend &= pend - 1;\n      }\n"
         "    } else {",
         "        __syncwarp();\n        pend &= pend - 1;\n      }\n"
         "      c_ins += clock64() - tp;\n    } else {"),
        ("    mbar_wait(&full[s], ph);\n    if (kc == 0) na = nbv = 0.f;\n"
         "    split_stage(s);",
         "    long long tw = clock64();\n    mbar_wait(&full[s], ph);\n"
         "    long long ts = clock64();\n    c_wait += ts - tw;\n"
         "    if (kc == 0) na = nbv = 0.f;\n    split_stage(s);\n"
         "    c_split += clock64() - ts;"),
        ("    asm volatile(\"fence.proxy.async.shared::cta;\" ::: \"memory\");"
         "\n    consumers_sync();\n  };",
         "    asm volatile(\"fence.proxy.async.shared::cta;\" ::: \"memory\");"
         "\n    long long tb = clock64();\n    consumers_sync();\n"
         "    c_bar += clock64() - tb;\n  };"),
        ("      epilogue(t);\n",
         "      long long t0 = clock64();\n      epilogue(t);\n"
         "      c_epi += clock64() - t0;\n"),
        ("    wgmma_wait_all();\n    pin<S::NACC>(part);\n",
         "    long long tm = clock64();\n    wgmma_wait_all();\n"
         "    c_mma += clock64() - tm;\n    pin<S::NACC>(part);\n"),
        ("  if constexpr (kFused) {\n    if (p.list_shared) {",
         f"  if (lane == 0 && blockIdx.x < {MAX_BLOCKS}) {{\n"
         "    long long* o = stage_cycles + (blockIdx.x * 8 + tid / 32) * 9;\n"
         "    o[0] = c_epi; o[1] = c_wait; o[2] = c_split; o[3] = c_bar;\n"
         "    o[4] = c_mma; o[5] = clock64() - c_all; o[6] = c_fil;\n"
         "    o[7] = c_ins; o[8] = c_np * 1000;\n  }\n"
         "  if constexpr (kFused) {\n    if (p.list_shared) {"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"l2_stage_cycles: the source changed near "
                             f"{old[:60]!r}; update the edits")
        src = src.replace(old, new)
    return src


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=262_144)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("l2_stage_cycles: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, _launch
    from repro_torch.kernels import l2 as l2_mod

    out_dir = os.path.join(ROOT, "build", "l2_stage_cycles")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "l2_distance_cycles.cu")
    with open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                           "l2_distance.cu")) as f:
        text = instrument(f.read())
    with open(cu, "w") as f:
        f.write(text)
    so = os.path.join(out_dir, "libl2_distance_cycles.so")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    flags = [a for a in _build.NVCC_FLAGS if a not in ("-Xptxas", "-v")]
    build = subprocess.run([nvcc, *flags, "-o", so, cu],
                           capture_output=True, text=True)
    if build.returncode != 0:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    mat = _launch.c_fn(lib, "l2_distance_f32", n_ptrs=3, n_ints=5)
    topk = _launch.c_fn(lib, "l2_topk_f32", n_ptrs=4, n_ints=6)
    lib.stage_cycles_get.argtypes = [ctypes.c_void_p, ctypes.c_int]

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = torch.nn.functional.normalize(
        torch.randn(args.n, 128, generator=gen, device="cuda"), dim=1)
    q = torch.nn.functional.normalize(
        torch.randn(1024, 128, generator=gen, device="cuda"), dim=1)

    def report(label, blocks):
        n = MAX_BLOCKS * 8 * 9
        buf = (ctypes.c_longlong * n)()
        lib.stage_cycles_get(ctypes.addressof(buf), n)
        a = np.frombuffer(buf, dtype=np.int64).reshape(MAX_BLOCKS, 8, 9)
        a = a[:blocks].reshape(-1, 9) / 1e3
        row = {"run": label, "blocks": blocks}
        for i, name in enumerate(SLOTS):
            row[name] = [round(float(a[:, i].mean()), 1),
                         round(float(a[:, i].max()), 1)]
        print(row, flush=True)

    for nq in (1024, 32):
        qq = q[:nq].contiguous()
        s = l2_mod.splits(nq, args.n, x.device)
        blocks = s * (1 if nq <= 32 else -(-nq // 128))
        out = torch.empty(nq, args.n, device="cuda")
        _launch.launch("matrix", mat, x.device, qq.data_ptr(), x.data_ptr(),
                       out.data_ptr(), nq, args.n, 128, 1, s)
        torch.cuda.synchronize()
        report(f"matrix Q={nq}", blocks)
        del out
        for k in (1, 10):
            cand = torch.empty(nq, s, k, dtype=torch.int64, device="cuda")
            _launch.launch("fused", topk, x.device, qq.data_ptr(),
                           x.data_ptr(), None, cand.data_ptr(), nq, args.n,
                           128, 1, k, s)
            torch.cuda.synchronize()
            report(f"fused k={k} Q={nq}", blocks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
