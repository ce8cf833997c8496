// Blocked distance matrix: every query against every corpus row.
//
// Replaces: src/repro/kernels/l2.py, l2_distance_kernel (Pallas body
// _l2_kernel):
//   q (Q, D) f32 x x (N, D) f32 -> out (Q, N) f32,
//   mode 0 = ||q||^2 + ||x||^2 - 2 q.x clamped at >= 0 (squared L2),
//   mode 1 = -q.x.
//
// What bounds it on an H100: operations.  It does 2 * Q * N * D flops
// against (Q + N) * D * 4 bytes read and Q * N * 4 written.  At the main
// path's shape, Q = 1,024 against one 65,536-row chunk at D = 128, the
// 1.72e10 flops take 0.256 ms at 67 TFLOP/s fp32 and the 0.30 GB move in
// 0.090 ms at 3.35 TB/s.
//
// Design: the TPU kernel hands the cross term to the MXU in 256 x 256 x 512
// VMEM tiles and accumulates over a sequential k grid axis.  Here the cross
// term stays exact fp32 on the CUDA cores: no TF32 and no tensor-core MMA,
// since TF32 reorders near neighbours.  A block of 256 threads owns a
// BM x 128 output tile (BM = 128, or 32 when Q <= 32, the batcher's
// buckets) and walks D in 16-deep slices.  Each slice of query rows and
// corpus rows is stored transposed in shared memory, and each thread keeps
// a TM x 8 micro-tile of accumulators in registers (64 at BM = 128), so one
// shared-memory read feeds 8 FMAs.  A thread's rows and columns sit in two
// groups of 4, half a tile apart: a quarter-warp's 16-byte shared reads
// then cover 32 distinct banks.  The next slice is fetched into registers
// (16-byte loads when D % 4 == 0) while the current one is multiplied.
// The squared norms are summed from the same shared slices, one row per
// thread, so the corpus is read once.  The epilogue writes qq + xx - 2 acc
// clamped at 0, or -acc, with 16-byte stores where N % 4 == 0.  Tails on
// every axis are zero-filled on load and masked on store, and output
// offsets are 64-bit (Q * N passes 2^31 at Q = 10,000 x 65,536).
//
// The kernel allocates nothing, launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kBN = 128;        // corpus rows per block
constexpr int kBK = 16;         // depth of one shared-memory slice
constexpr int kTN = 8;          // corpus rows per thread
constexpr int kPad = 4;         // keeps the 16-byte alignment of a row

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// TM: query rows per thread (BM = 16 * TM).  kVec: 16-byte loads (D % 4 == 0
// and both inputs 16-byte aligned), else 4-byte loads.
template <int TM, bool kVec>
__global__ void __launch_bounds__(kThreads)
l2_distance_kernel(const float* __restrict__ q, const float* __restrict__ x,
                   float* __restrict__ out, int Q, int N, int D, int mode,
                   int vec_out) {
  constexpr int kBM = 16 * TM;
  constexpr int kHM = TM / 2;               // rows per thread in each half
  constexpr int kAV4 = kBM * kBK / 4;       // float4s in a query slice
  constexpr int kBV4 = kBN * kBK / 4;       // float4s in a corpus slice
  constexpr int kAV = (kAV4 + kThreads - 1) / kThreads;
  constexpr int kBV = kBV4 / kThreads;
  constexpr int kAS = kBM * kBK / kThreads; // floats per thread, 4-byte loads
  constexpr int kBS = kBN * kBK / kThreads;
  constexpr int kAR = kVec ? 4 * kAV : kAS;
  constexpr int kBR = kVec ? 4 * kBV : kBS;

  __shared__ __align__(16) float a_s[kBK][kBM + kPad];
  __shared__ __align__(16) float b_s[kBK][kBN + kPad];
  __shared__ float qn_s[kBM];
  __shared__ float xn_s[kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const bool l2 = mode == 0;

  float ra[kAR], rb[kBR];

  // the slice at depth k0 into registers, zero beyond Q, N and D.  16-byte
  // loads: four lanes cover 64 contiguous bytes of one row.
  auto fetch = [&](int k0) {
    if constexpr (kVec) {
#pragma unroll
      for (int p = 0; p < kAV; ++p) {
        const int i = tid + p * kThreads, r = i / 4, gk = k0 + 4 * (i % 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < kAV4 && m0 + r < Q && gk < D)
          v = __ldg(reinterpret_cast<const float4*>(
              q + static_cast<size_t>(m0 + r) * D + gk));
        ra[4 * p] = v.x;
        ra[4 * p + 1] = v.y;
        ra[4 * p + 2] = v.z;
        ra[4 * p + 3] = v.w;
      }
#pragma unroll
      for (int p = 0; p < kBV; ++p) {
        const int i = tid + p * kThreads, r = i / 4, gk = k0 + 4 * (i % 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n0 + r < N && gk < D)
          v = __ldg(reinterpret_cast<const float4*>(
              x + static_cast<size_t>(n0 + r) * D + gk));
        rb[4 * p] = v.x;
        rb[4 * p + 1] = v.y;
        rb[4 * p + 2] = v.z;
        rb[4 * p + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int p = 0; p < kAS; ++p) {
        const int i = tid + p * kThreads, r = i / kBK, gk = k0 + i % kBK;
        ra[p] = (m0 + r < Q && gk < D)
                    ? __ldg(q + static_cast<size_t>(m0 + r) * D + gk)
                    : 0.f;
      }
#pragma unroll
      for (int p = 0; p < kBS; ++p) {
        const int i = tid + p * kThreads, r = i / kBK, gk = k0 + i % kBK;
        rb[p] = (n0 + r < N && gk < D)
                    ? __ldg(x + static_cast<size_t>(n0 + r) * D + gk)
                    : 0.f;
      }
    }
  };

  // the registers into shared memory, transposed: a_s[k][row]
  auto stash = [&]() {
    if constexpr (kVec) {
#pragma unroll
      for (int p = 0; p < kAV; ++p) {
        const int i = tid + p * kThreads, r = i / 4, c = 4 * (i % 4);
        if (i < kAV4) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a_s[c + e][r] = ra[4 * p + e];
        }
      }
#pragma unroll
      for (int p = 0; p < kBV; ++p) {
        const int i = tid + p * kThreads, r = i / 4, c = 4 * (i % 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) b_s[c + e][r] = rb[4 * p + e];
      }
    } else {
#pragma unroll
      for (int p = 0; p < kAS; ++p) {
        const int i = tid + p * kThreads;
        a_s[i % kBK][i / kBK] = ra[p];
      }
#pragma unroll
      for (int p = 0; p < kBS; ++p) {
        const int i = tid + p * kThreads;
        b_s[i % kBK][i / kBK] = rb[p];
      }
    }
  };

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;   // squared norm of this thread's row (l2 mode)

  fetch(0);
  for (int k0 = 0; k0 < D; k0 += kBK) {
    stash();
    __syncthreads();
    if (k0 + kBK < D) fetch(k0 + kBK);
    if (l2) {
      if (tid < kBM) {
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          const float v = a_s[kk][tid];
          nrm = fmaf(v, v, nrm);
        }
      } else if (tid < kBM + kBN) {
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          const float v = b_s[kk][tid - kBM];
          nrm = fmaf(v, v, nrm);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[kTN];
      if constexpr (kHM == 4) {
        const float4 lo =
            *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
        const float4 hi =
            *reinterpret_cast<const float4*>(&a_s[kk][kBM / 2 + ty * 4]);
        a[0] = lo.x; a[1] = lo.y; a[2] = lo.z; a[3] = lo.w;
        a[4] = hi.x; a[5] = hi.y; a[6] = hi.z; a[7] = hi.w;
      } else {
#pragma unroll
        for (int i = 0; i < kHM; ++i) {
          a[i] = a_s[kk][ty * kHM + i];
          a[kHM + i] = a_s[kk][kBM / 2 + ty * kHM + i];
        }
      }
      const float4 lo = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
      const float4 hi =
          *reinterpret_cast<const float4*>(&b_s[kk][kBN / 2 + tx * 4]);
      b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
      b[4] = hi.x; b[5] = hi.y; b[6] = hi.z; b[7] = hi.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < kBM)
    qn_s[tid] = nrm;
  else if (tid < kBM + kBN)
    xn_s[tid - kBM] = nrm;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int lr = i < kHM ? ty * kHM + i : kBM / 2 + ty * kHM + (i - kHM);
    const int gr = m0 + lr;
    if (gr >= Q) continue;
    float* o = out + static_cast<size_t>(gr) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lc = h * (kBN / 2) + tx * 4;
      const int gc = n0 + lc;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float c = acc[i][4 * h + e];
        v[e] = l2 ? fmaxf(qn_s[lr] + xn_s[lc + e] - 2.f * c, 0.f) : -c;
      }
      if (vec_out && gc + 3 < N) {
        *reinterpret_cast<float4*>(o + gc) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gc + e < N) o[gc + e] = v[e];
      }
    }
  }
}

template <int TM, bool kVec>
int launch(const float* q, const float* x, float* out, int Q, int N, int D,
           int mode, int vec_out, cudaStream_t s) {
  constexpr int kBM = 16 * TM;
  const dim3 grid((N + kBN - 1) / kBN, (Q + kBM - 1) / kBM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  l2_distance_kernel<TM, kVec><<<grid, kThreads, 0, s>>>(q, x, out, Q, N, D,
                                                         mode, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int l2_distance_f32(const float* q, const float* x, float* out,
                               int Q, int N, int D, int mode, void* stream) {
  if (Q <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (D < 0 || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 && aligned16(q) && aligned16(x);
  const int vec_out = N % 4 == 0 && aligned16(out);
  if (Q <= 32)
    return vec ? launch<2, true>(q, x, out, Q, N, D, mode, vec_out, s)
               : launch<2, false>(q, x, out, Q, N, D, mode, vec_out, s);
  return vec ? launch<8, true>(q, x, out, Q, N, D, mode, vec_out, s)
             : launch<8, false>(q, x, out, Q, N, D, mode, vec_out, s);
}
