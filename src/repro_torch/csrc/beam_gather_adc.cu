// Code-domain fused gather + ADC for the PQ engine's wide-beam HNSW
// traversal, batched over queries.
//
// Replaces: src/repro/kernels/beam_gather.py, beam_gather_adc_kernel
// (Pallas body _beam_adc_kernel, DMA gather _gather_rows).  The JAX package
// calls that kernel under vmap, one query at a time; this one takes the
// batch:
//   lut (Q, m, k) f32 x ids (Q, L) i32 x codes (N, m) u8 | i32
//     -> out (Q, L) f32,  out[q, l] = sum_i lut[q, i, codes[ids[q, l], i]].
//
// What bounds it on an H100: bytes.  Each query's LUT is m * k * 4 bytes
// (16 KB at m = 16, k = 256) and is read once; each id reads one m-byte
// code row; the sum is m fp32 adds.  At the search's shape (L = 128) the
// LUTs are 8x the code bytes, so the floor is (Q LUTs + unique rows + ids +
// output) over 3.35 TB/s.
//
// Design: the Pallas kernel expands codes into a one-hot matrix and
// contracts it with the LUT on the MXU, because a TPU core has no fast
// data-dependent gather from VMEM.  Shared memory is exactly that here:
// one block per query copies its LUT into shared memory with 16-byte
// loads, then each thread takes one id, loads its m code bytes in one
// 16-byte load (m = 16, uint8) and sums m direct LUT reads.  The reads are
// data-dependent, so lanes of a warp hit random banks (about 3.5-way
// conflicts for 32 uniform codes); nothing cheaper avoids that without
// replicating the LUT.  For L < 32 (the entry-point call, L = 1) copying
// 16 KB to read m entries per id costs more than it saves, so the block
// reads the LUT from global memory instead.  The ids are loaded by the
// block itself (no scalar prefetch, no DMA semaphores).
//
// The kernel allocates nothing, launches on the caller's stream and returns
// cudaGetLastError().  Ids are clamped to [0, N) as JAX's gather clamps
// them; codes must lie in [0, k).

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_row.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMinSmemL = 32;              // below this, LUT from global
constexpr int kMaxSmemBytes = 200 * 1024;

template <typename CodeT, bool kRow16, bool kSmem>
__global__ void __launch_bounds__(kThreads)
beam_gather_adc_kernel(const float* __restrict__ lut,
                       const int32_t* __restrict__ ids,
                       const CodeT* __restrict__ codes,
                       float* __restrict__ out, int L, int m, int k, int N) {
  extern __shared__ float4 lut_s4[];
  const int qi = blockIdx.x;
  const int mk = m * k;
  const float* lut_q = lut + static_cast<size_t>(qi) * mk;
  const float* tab = lut_q;
  if constexpr (kSmem) {
    float* lut_s = reinterpret_cast<float*>(lut_s4);
    if ((mk & 3) == 0 && (reinterpret_cast<uintptr_t>(lut_q) & 15) == 0) {
      const float4* src = reinterpret_cast<const float4*>(lut_q);
      for (int e = threadIdx.x; e < (mk >> 2); e += kThreads)
        lut_s4[e] = __ldg(src + e);
    } else {
      for (int e = threadIdx.x; e < mk; e += kThreads)
        lut_s[e] = __ldg(lut_q + e);
    }
    __syncthreads();
    tab = lut_s;
  }
  for (int l = threadIdx.x; l < L; l += kThreads) {
    int row = ids[static_cast<size_t>(qi) * L + l];
    row = min(max(row, 0), N - 1);
    const CodeT* c = codes + static_cast<size_t>(row) * m;
    float acc;
    if constexpr (kRow16) {
      adc::Row16 r;
      r.load(reinterpret_cast<const uint8_t*>(c));
      acc = r.sum(tab, k);
    } else {
      acc = adc::sum_generic(tab, c, m, k);
    }
    out[static_cast<size_t>(qi) * L + l] = acc;
  }
}

template <typename CodeT, bool kRow16>
int launch(const float* lut, const int32_t* ids, const CodeT* codes,
           float* out, int Q, int L, int m, int k, int N, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(m) * k * sizeof(float);
  if (L >= kMinSmemL && smem <= kMaxSmemBytes) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(beam_gather_adc_kernel<CodeT, kRow16, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    beam_gather_adc_kernel<CodeT, kRow16, true><<<Q, kThreads, smem, s>>>(
        lut, ids, codes, out, L, m, k, N);
  } else {
    beam_gather_adc_kernel<CodeT, kRow16, false><<<Q, kThreads, 0, s>>>(
        lut, ids, codes, out, L, m, k, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// code_bytes: 1 = uint8 codes, 4 = int32 codes
extern "C" int beam_gather_adc_f32(const float* lut, const int32_t* ids,
                                   const void* codes, float* out, int Q,
                                   int L, int m, int k, int N, int code_bytes,
                                   void* stream) {
  if (Q <= 0 || L <= 0) return static_cast<int>(cudaSuccess);
  if (m <= 0 || k <= 0 || N <= 0 || (code_bytes != 1 && code_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 4)
    return launch<int32_t, false>(lut, ids, static_cast<const int32_t*>(codes),
                                  out, Q, L, m, k, N, s);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  if (adc::row16(m, reinterpret_cast<uintptr_t>(codes)))
    return launch<uint8_t, true>(lut, ids, c, out, Q, L, m, k, N, s);
  return launch<uint8_t, false>(lut, ids, c, out, Q, L, m, k, N, s);
}
