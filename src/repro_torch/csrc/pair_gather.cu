// Fused candidate gather + pairwise distance matrix for the bulk HNSW
// build's Alg-4 diversification prune, batched over prune nodes.
//
// Replaces: src/repro/kernels/bulk_prune.py, pair_gather_kernel (Pallas
// body _pair_kernel).  The JAX package calls it under vmap over the prune
// batch; this one takes the batch:
//   ids (B, C) i32 x corpus (N, D) f32 -> out (B, C, C) f32,
//   mode 0 = max(|a|^2 + |b|^2 - 2 a.b, 0), mode 1 = -a.b.
//
// What bounds it on an H100: at the main path's C = 60-80 it does
// 2 * C * C * D flops per node against C * D * 4 bytes of gathered rows plus
// C * C * 4 bytes of output, about C / 2 flops per byte (30 at C = 60, 40 at
// C = 80), above the fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20.  So the
// floor is the fp32 FMA rate; bytes bound it only for C under about 40.
//
// Design: one block per prune node.  The C gathered rows do not fit shared
// memory whole (C = 80, D = 784 is 250 KB, over the 227 KB a block can
// have), so the block walks D in slices of 32: each step stages a 32-wide
// slice of the tile's rows in shared memory (a warp reads 128 contiguous
// bytes of a row) and every thread accumulates an 8 x 8 register micro-tile
// with fp32 FMAs.  The output tile is the smallest of 64, 96 or 128 that
// holds C (C = 60 -> 64, C = 80 -> 96), so little of the work is padding;
// C above 128 loops over 128-wide tiles, diagonal tiles first.  A diagonal
// tile stages its rows once and reads them as both operands, and its
// diagonal gives the row norms of the L2 epilogue (clamped at 0 as the
// Pallas kernel does).  No TF32 and no tensor cores: fp32 parity with the
// plain version comes first, tensor cores are later work.
//
// The kernel allocates nothing, launches on the caller's stream and returns
// cudaGetLastError().  Out-of-range ids are clamped to [0, N); callers pass
// valid ids.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTD = 32;         // depth of one staged D slice
constexpr int kMicro = 8;       // outputs per thread along each axis
constexpr int kMaxC = 256;

template <int kTile, bool kL2>
__global__ void __launch_bounds__((kTile / kMicro) * (kTile / kMicro))
pair_gather_f32_kernel(const int32_t* __restrict__ ids,
                       const float* __restrict__ corpus,
                       float* __restrict__ out, int C, int D, int N) {
  constexpr int kT = kTile / kMicro;          // threads along each axis
  constexpr int kThreads = kT * kT;
  __shared__ float a_s[kTD][kTile + 1];
  __shared__ float b_s[kTD][kTile + 1];
  __shared__ int rows[kMaxC];
  __shared__ float norms[kMaxC];

  const int node = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < C; i += kThreads) {
    const int r = ids[static_cast<size_t>(node) * C + i];
    rows[i] = min(max(r, 0), N - 1);
  }
  __syncthreads();

  const int tx = tid % kT, ty = tid / kT;
  const int nt = (C + kTile - 1) / kTile;
  float* o = out + static_cast<size_t>(node) * C * C;
  // diagonal tiles first: their diagonals are the norms the others need
  for (int p = 0; p < nt * nt; ++p) {
    int ti, tj;
    if (p < nt) {
      ti = tj = p;
    } else {
      const int q = p - nt, r = q % (nt - 1);
      ti = q / (nt - 1);
      tj = r < ti ? r : r + 1;
    }
    const int i0 = ti * kTile, j0 = tj * kTile;
    const bool diag = ti == tj;
    float acc[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kTD) {
      // stage the slice transposed, so the product loop reads one shared
      // memory row per step; a diagonal tile needs one operand only
      for (int e = tid; e < kTile * kTD; e += kThreads) {
        const int r = e / kTD, c = e % kTD;
        const int gd = d0 + c;
        const int gi = i0 + r;
        a_s[c][r] = (gi < C && gd < D)
            ? __ldg(corpus + static_cast<size_t>(rows[gi]) * D + gd) : 0.f;
        if (!diag) {
          const int gj = j0 + r;
          b_s[c][r] = (gj < C && gd < D)
              ? __ldg(corpus + static_cast<size_t>(rows[gj]) * D + gd) : 0.f;
        }
      }
      __syncthreads();
      const float (*bs)[kTile + 1] = diag ? a_s : b_s;
#pragma unroll 4
      for (int c = 0; c < kTD; ++c) {
        float a[kMicro], b[kMicro];
#pragma unroll
        for (int k = 0; k < kMicro; ++k) a[k] = a_s[c][ty + kT * k];
#pragma unroll
        for (int k = 0; k < kMicro; ++k) b[k] = bs[c][tx + kT * k];
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    if (kL2 && diag) {
      if (tx == ty) {
#pragma unroll
        for (int i = 0; i < kMicro; ++i) {
          const int g = i0 + ty + kT * i;
          if (g < C) norms[g] = acc[i][i];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int gi = i0 + ty + kT * i;
      if (gi >= C) continue;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const int gj = j0 + tx + kT * j;
        if (gj >= C) continue;
        const float g = acc[i][j];
        o[static_cast<size_t>(gi) * C + gj] =
            kL2 ? fmaxf(norms[gi] + norms[gj] - 2.f * g, 0.f) : -g;
      }
    }
  }
}

template <int kTile>
void launch(const int32_t* ids, const float* corpus, float* out, int B,
            int C, int D, int N, int mode, cudaStream_t s) {
  constexpr int threads = (kTile / kMicro) * (kTile / kMicro);
  if (mode == 0)
    pair_gather_f32_kernel<kTile, true><<<B, threads, 0, s>>>(
        ids, corpus, out, C, D, N);
  else
    pair_gather_f32_kernel<kTile, false><<<B, threads, 0, s>>>(
        ids, corpus, out, C, D, N);
}

}  // namespace

extern "C" int pair_gather_f32(const int32_t* ids, const float* corpus,
                               float* out, int B, int C, int D, int N,
                               int mode, void* stream) {
  if (B <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  if (C > kMaxC || D <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 64)
    launch<64>(ids, corpus, out, B, C, D, N, mode, s);
  else if (C <= 96)
    launch<96>(ids, corpus, out, B, C, D, N, mode, s);
  else
    launch<128>(ids, corpus, out, B, C, D, N, mode, s);
  return static_cast<int>(cudaGetLastError());
}
