#!/usr/bin/env python3
"""Where B8's cycles go inside the kernel, per block and step.

Builds an instrumented copy of ``src/repro_torch/csrc/slstm.cu`` under
``build/slstm_stage_cycles/`` (clock64() read by thread 0 of each block at
the borders of the stages of one step, the sums written to a device array)
and runs B8 at xlstm-1.3b's full width (bf16 gates, B = 8, S = 2,048,
d = 2,048, 4 heads) on both of its paths:

  l2       the cooperative kernel that reads R from L2 or from its block's
           shared memory and ends every step with a grid barrier (the only
           kernel before the cluster path; it now takes the shapes the
           cluster layout cannot hold), stages:
             loads    the state and gate loads,
             h_stage  staging h_{t-1} from L2 into shared memory,
             product  the recurrent product,
             reduce   the warp and block reduction,
             cell     the cell, its stores and the block barrier after it,
             barrier  the grid barrier;
  cluster  one thread-block cluster per (head, batch-row group), R on chip,
           h exchanged through distributed shared memory, the rows in two
           halves a half-step apart; stages (both halves of a step, as
           thread 0 sees them):
             wait      the wait for every peer's h slices (mbarrier),
             product   the recurrent product,
             reduce    the partial sums through shared memory,
             cell_send the cell of thread 0's half and its stores, the
                       barrier after the cells, and the sends of h to every
                       peer (st.async; both halves).

For each path and stage it prints the mean and the largest per-block
kcycles per step.  The instrumented copy is a measuring tool, not the port's
kernel: the clock reads stretch it a little.  Run on a card from the
repository root:

    python3 scripts/slstm_stage_cycles.py
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

B, S, D, H = 8, 2048, 2048, 4
MAX_BLOCKS = 1024
NSLOT = 6
STAGES = {"l2": ("loads", "h_stage", "product", "reduce", "cell", "barrier"),
          "cluster": ("wait", "product", "reduce", "cell_send")}

HEADER = (
    "#include <cuda_runtime.h>\n"
    f"__device__ long long stage_cycles[{MAX_BLOCKS} * {NSLOT}];\n"
    "extern \"C\" int stage_cycles_get(long long* out, int n) {\n"
    "  return (int)cudaMemcpyFromSymbol(out, stage_cycles, n * 8);\n}\n"
    "extern \"C\" int stage_cycles_clear() {\n"
    f"  static long long z[{MAX_BLOCKS} * {NSLOT}];\n"
    "  return (int)cudaMemcpyToSymbol(stage_cycles, z, sizeof(z));\n}\n"
    "#define MARK(i) do { long long now_ = clock64(); cyc[i] += now_ - tp; "
    "tp = now_; } while (0)\n")


def _dump(block: str) -> str:
    return (f"  if (threadIdx.x == 0 && {block} < {MAX_BLOCKS})\n"
            f"    for (int i_ = 0; i_ < {NSLOT}; ++i_)\n"
            f"      stage_cycles[({block}) * {NSLOT} + i_] = cyc[i_];\n")


# (old, new) text edits of the l2 path's kernel
L2_EDITS = [
    ("  for (int t = 0; t < S; ++t) {\n    const float* h_prev",
     f"  long long cyc[{NSLOT}] = {{0, 0, 0, 0, 0, 0}}, tp = 0;\n"
     "  for (int t = 0; t < S; ++t) {\n    tp = clock64();\n"
     "    const float* h_prev"),
    ("        float acc[4][kBB];\n",
     "        MARK(0);\n        float acc[4][kBB];\n"),
    ("          __syncthreads();\n          if (l < blk) {",
     "          __syncthreads();\n          MARK(1);\n"
     "          if (l < blk) {"),
    ("        // the warp's two k-slices (lanes u and u + 16), then the warps",
     "        MARK(2);\n"
     "        // the warp's two k-slices (lanes u and u + 16), then the warps"),
    ("        __syncthreads();\n\n        if (cell) {\n          float pre[4];",
     "        __syncthreads();\n        MARK(3);\n\n"
     "        if (cell) {\n          float pre[4];"),
    ("        __syncthreads();                // h_s and red are reused\n",
     "        __syncthreads();                // h_s and red are reused\n"
     "        MARK(4);\n"),
    ("    grid.sync();                        // h_t visible to every block\n"
     "  }\n}\n",
     "    grid.sync();                        // h_t visible to every block\n"
     "    MARK(5);\n  }\n" + _dump("blockIdx.x") + "}\n"),
]

# (old, new) text edits of the cluster path's kernel (both halves of a step;
# thread 0 runs the cell of the first half)
CLUSTER_EDITS = [
    ("  for (int u = 0; u < 2 * S; ++u) {\n",
     f"  long long cyc[{NSLOT}] = {{0, 0, 0, 0, 0, 0}}, tp = 0;\n"
     "  for (int u = 0; u < 2 * S; ++u) {\n    tp = clock64();\n"),
    ("    // the product: h_x(t-1) x this block's R columns\n",
     "    MARK(0);\n    // the product: h_x(t-1) x this block's R columns\n"),
    ("    // this lane's partial sums, in the order ks = 0..15 later\n",
     "    MARK(1);\n"
     "    // this lane's partial sums, in the order ks = 0..15 later\n"),
    ("    __syncthreads();                  // red complete\n",
     "    __syncthreads();                  // red complete\n    MARK(2);\n"),
    ("    // half-step u done\n",
     "    MARK(3);\n    // half-step u done\n"),
    ("  // the kernel's end: no peer writes into this block any more\n",
     _dump("(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x")
     +
     "  // the kernel's end: no peer writes into this block any more\n"),
]

ENTRIES = (
    "extern \"C\" int cycles_l2_bf16(const void* g, const float* r,\n"
    "    const float* b, void* out, float* scratch, int B, int S, int d,\n"
    "    int H, void* stream) {\n"
    "  return run_l2<__nv_bfloat16>(\n"
    "      static_cast<const __nv_bfloat16*>(g), r, b,\n"
    "      static_cast<__nv_bfloat16*>(out), scratch, B, S, d, H,\n"
    "      static_cast<cudaStream_t>(stream));\n}\n")


def instrument(src: str, path: str) -> str:
    """The kernel source with per-block cycle counters in one path: exact
    text edits, each of which must find its place."""
    for old, new in (L2_EDITS if path == "l2" else CLUSTER_EDITS):
        if src.count(old) != 1:
            raise SystemExit(f"slstm_stage_cycles: the source changed near "
                             f"{old[:60]!r}; update the edits")
        src = src.replace(old, new)
    return HEADER + src + (ENTRIES if path == "l2" else "")


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("slstm_stage_cycles: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, _launch

    out_dir = os.path.join(ROOT, "build", "slstm_stage_cycles")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                           "slstm.cu")) as f:
        text = f.read()
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    flags = [a for a in _build.NVCC_FLAGS if a not in ("-Xptxas", "-v")]
    procs = {}
    for path in STAGES:
        cu = os.path.join(out_dir, f"slstm_{path}_cycles.cu")
        with open(cu, "w") as f:
            f.write(instrument(text, path))
        so = os.path.join(out_dir, f"libslstm_{path}_cycles.so")
        procs[path] = (so, subprocess.Popen(
            [nvcc, *flags, "-I", str(_build.CSRC),
             "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for path, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        libs[path] = ctypes.CDLL(so)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    blk = D // H
    gates = torch.randn((B, S, 4 * D), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    r = torch.randn((4, H, blk, blk), generator=gen, device="cuda") \
        * blk ** -0.5
    bias = torch.randn((4 * D,), generator=gen, device="cuda")
    out = torch.empty((B, S, D), dtype=torch.bfloat16, device="cuda")
    scratch = torch.empty((5, B, D), device="cuda")
    for path, lib in libs.items():
        lib.stage_cycles_get.argtypes = [ctypes.c_void_p, ctypes.c_int]
        if path == "l2":
            fn = _launch.c_fn(lib, "cycles_l2_bf16", n_ptrs=5, n_ints=4)
            args = (gates.data_ptr(), r.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), scratch.data_ptr(), B, S, D, H)
        else:
            fn = _launch.c_fn(lib, "slstm_sequence_bf16", n_ptrs=6,
                              n_ints=4)
            info = (ctypes.c_int * 4)()
            args = (gates.data_ptr(), r.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), scratch.data_ptr(),
                    ctypes.addressof(info), B, S, D, H)
        for _ in range(2):              # the second run is the one read
            lib.stage_cycles_clear()
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            a.record()
            _launch.launch(path, fn, gates.device, *args)
            e.record()
            torch.cuda.synchronize()
        n = MAX_BLOCKS * NSLOT
        buf = (ctypes.c_longlong * n)()
        lib.stage_cycles_get(ctypes.addressof(buf), n)
        cyc = np.frombuffer(buf, dtype=np.int64).reshape(MAX_BLOCKS, NSLOT)
        cyc = cyc[cyc.sum(1) > 0] / (S * 1e3)
        row = {"path": path, "blocks": int(cyc.shape[0]),
               "instrumented_ms": a.elapsed_time(e)}
        if path == "cluster":
            _, row["rows_per_cluster"], row["cluster_size"], \
                row["active_clusters"] = list(info)
        for i, name in enumerate(STAGES[path]):
            row[name] = [round(float(cyc[:, i].mean()), 3),
                         round(float(cyc[:, i].max()), 3)]
        row["step_total"] = round(float(cyc.sum(1).mean()), 3)
        print(row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
