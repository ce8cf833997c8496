// PQ asymmetric distance scan: every query's LUT against every code row.
//
// Replaces: src/repro/kernels/pq_adc.py, pq_adc_kernel (Pallas body
// _adc_kernel):
//   lut (Q, m, k) f32 x codes (N, m) u8 | i32 -> out (Q, N) f32,
//   out[q, n] = sum_i lut[q, i, codes[n, i]], added in the order i = 0..m-1.
//
// What bounds it on an H100: bytes.  The output is Q * N * 4 bytes
// (256 MB at Q = 1024 against one 65,536-row chunk, or Q = 64 against 1M
// rows), against N * m code bytes and Q * m * k * 4 LUT bytes, and it
// does Q * N * m fp32 adds: m / 4 adds per output byte (4 at m = 16),
// under the card's fp32 rate over its memory rate (67 / 3.35 = 20).  So
// the floor is the output write.
//
// Design: the Pallas kernel turns the gather into a one-hot MXU
// contraction, a TPU workaround.  Here a block takes a tile of TQ = 4
// queries x 4,096 code rows: it copies the 4 LUTs (64 KB at m = 16,
// k = 256, dynamic shared memory) once, then each of its 256 threads
// walks 16 rows: it loads a row's m code bytes into registers (one 16-byte
// load at m = 16) and, for each of the 4 queries, sums m shared-memory LUT
// reads and writes out[q, n] (lanes on consecutive n: coalesced stores).
// A row's codes are loaded once for the 4 queries; a LUT tile is copied
// once per 4,096 rows (Q * N / 1024 LUT bytes over the whole scan, mostly
// L2 hits since all Q LUTs are 16 MB).  Bank conflicts: for a fixed query
// and sub-space the 32 lanes of a warp read one k-float LUT row at 32
// data-dependent offsets, so about 3.5 lanes share the busiest bank for
// uniform codes.  Padding the LUT rows does not help (the offset itself is
// random), and replicating the LUT per lane does not fit; the chosen
// layout keeps the LUT contiguous and accepts those conflicts.  A LUT tile
// that does not fit shared memory (m * k * 4 * TQ over 200 KB, i.e. very
// large k) is read from global memory instead.
//
// The kernel allocates nothing, launches on the caller's stream and returns
// cudaGetLastError().  Codes must lie in [0, k).

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;
constexpr int kTQ = 4;
constexpr int kMaxSmemBytes = 200 * 1024;

template <typename CodeT, bool kRow16, bool kSmem>
__global__ void __launch_bounds__(kThreads)
pq_adc_kernel(const float* __restrict__ lut, const CodeT* __restrict__ codes,
              float* __restrict__ out, int Q, int N, int m, int k) {
  extern __shared__ float4 lut_s4[];
  const int q0 = blockIdx.y * kTQ;
  const int nq = min(kTQ, Q - q0);
  const int mk = m * k;
  const float* lut_t = lut + static_cast<size_t>(q0) * mk;
  const float* tab = lut_t;
  if constexpr (kSmem) {
    // the tile's nq LUTs are one contiguous run of nq * m * k floats
    float* lut_s = reinterpret_cast<float*>(lut_s4);
    const int total = nq * mk;
    if ((total & 3) == 0 && (reinterpret_cast<uintptr_t>(lut_t) & 15) == 0) {
      const float4* src = reinterpret_cast<const float4*>(lut_t);
      for (int e = threadIdx.x; e < (total >> 2); e += kThreads)
        lut_s4[e] = __ldg(src + e);
    } else {
      for (int e = threadIdx.x; e < total; e += kThreads)
        lut_s[e] = __ldg(lut_t + e);
    }
    __syncthreads();
    tab = lut_s;
  }
  const int n_begin = static_cast<int>(blockIdx.x) * kRowsPerBlock;
  const int n_end = min(N, n_begin + kRowsPerBlock);
  for (int n = n_begin + static_cast<int>(threadIdx.x); n < n_end;
       n += kThreads) {
    const CodeT* c = codes + static_cast<size_t>(n) * m;
    float* o = out + static_cast<size_t>(q0) * N + n;
    if constexpr (kRow16) {
      adc::Row16 r;
      r.load(reinterpret_cast<const uint8_t*>(c));
      for (int qq = 0; qq < nq; ++qq)
        o[static_cast<size_t>(qq) * N] = r.sum(tab + qq * mk, k);
    } else {
      for (int qq = 0; qq < nq; ++qq)
        o[static_cast<size_t>(qq) * N] =
            adc::sum_generic(tab + qq * mk, c, m, k);
    }
  }
}

template <typename CodeT, bool kRow16>
int launch(const float* lut, const CodeT* codes, float* out, int Q, int N,
           int m, int k, cudaStream_t s) {
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock,
                  (Q + kTQ - 1) / kTQ);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kTQ) * m * k * sizeof(float);
  if (smem <= kMaxSmemBytes) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(pq_adc_kernel<CodeT, kRow16, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    pq_adc_kernel<CodeT, kRow16, true><<<grid, kThreads, smem, s>>>(
        lut, codes, out, Q, N, m, k);
  } else {
    pq_adc_kernel<CodeT, kRow16, false><<<grid, kThreads, 0, s>>>(
        lut, codes, out, Q, N, m, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// code_bytes: 1 = uint8 codes, 4 = int32 codes
extern "C" int pq_adc_f32(const float* lut, const void* codes, float* out,
                          int Q, int N, int m, int k, int code_bytes,
                          void* stream) {
  if (Q <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (m <= 0 || k <= 0 || (code_bytes != 1 && code_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 4)
    return launch<int32_t, false>(lut, static_cast<const int32_t*>(codes), out,
                                  Q, N, m, k, s);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  if (adc::row16(m, reinterpret_cast<uintptr_t>(codes)))
    return launch<uint8_t, true>(lut, c, out, Q, N, m, k, s);
  return launch<uint8_t, false>(lut, c, out, Q, N, m, k, s);
}
