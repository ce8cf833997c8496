// Fused row gather + distance for wide-beam HNSW traversal, batched over
// queries.
//
// Replaces: src/repro/kernels/beam_gather.py, beam_gather_kernel (Pallas
// body _beam_kernel, DMA gather _gather_rows).  The JAX package calls that
// kernel under vmap, one query at a time; this one takes the batch:
//   q (Q, D) f32 x ids (Q, L) i32 x corpus (N, D) f32 -> out (Q, L) f32,
//   mode 0 = squared L2 as diff-square-sum, mode 1 = -q.x.
//
// What bounds it on an H100: bytes.  Each output reads one corpus row of
// D * 4 bytes (512 B at D = 128, 3 KB at D = 784) picked by a data-dependent
// id, and does 2-3 flops per element it reads, far under the card's
// 67 TFLOP/s fp32.  The floor is the unique rows touched over 3.35 TB/s.
//
// Design: the TPU version DMAs TB rows into VMEM because the ids ride in
// scalar prefetch.  Here one warp owns one (query, id) pair: it loads its
// row with 16-byte vector loads (D = 128 is one float4 per lane, D = 784 a
// loop of 196 float4s over the warp), neighbouring lanes on neighbouring
// addresses, and reduces with __shfl_xor_sync.  The query row sits in shared
// memory, loaded once per block of 8 ids.  Many warps in flight hide the
// latency of the random row reads.  L2 stays diff-square-sum (not the norm
// expansion) so width 1 keeps the single-pop traversal's arithmetic.
//
// The kernel allocates nothing, launches on the caller's stream and returns
// cudaGetLastError().  Out-of-range ids are clamped to [0, N) as JAX's
// gather clamps them; callers pass valid ids.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // ids per block, one warp each
constexpr int kThreads = kWarps * 32;

template <bool kL2>
__global__ void __launch_bounds__(kThreads)
beam_gather_f32_kernel(const float* __restrict__ q,
                       const int32_t* __restrict__ ids,
                       const float* __restrict__ corpus,
                       float* __restrict__ out, int L, int D, int N) {
  extern __shared__ float4 q_smem4[];
  float* q_smem = reinterpret_cast<float*>(q_smem4);
  const int qi = blockIdx.x;
  const float* q_row = q + static_cast<size_t>(qi) * D;
  for (int d = threadIdx.x; d < D; d += kThreads) q_smem[d] = q_row[d];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.y * kWarps + warp;
  if (l >= L) return;
  int row = ids[static_cast<size_t>(qi) * L + l];
  row = min(max(row, 0), N - 1);
  const float* x = corpus + static_cast<size_t>(row) * D;

  float acc = 0.f;
  if ((D & 3) == 0 && (reinterpret_cast<uintptr_t>(corpus) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int d4 = D >> 2;
    for (int i = lane; i < d4; i += 32) {
      const float4 a = __ldg(x4 + i);
      const float4 b = q_smem4[i];
      if (kL2) {
        float t;
        t = a.x - b.x; acc = fmaf(t, t, acc);
        t = a.y - b.y; acc = fmaf(t, t, acc);
        t = a.z - b.z; acc = fmaf(t, t, acc);
        t = a.w - b.w; acc = fmaf(t, t, acc);
      } else {
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        acc = fmaf(a.w, b.w, acc);
      }
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      const float a = __ldg(x + i);
      if (kL2) {
        const float t = a - q_smem[i];
        acc = fmaf(t, t, acc);
      } else {
        acc = fmaf(a, q_smem[i], acc);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[static_cast<size_t>(qi) * L + l] = kL2 ? acc : -acc;
}

}  // namespace

extern "C" int beam_gather_f32(const float* q, const int32_t* ids,
                               const float* corpus, float* out, int Q, int L,
                               int D, int N, int mode, void* stream) {
  if (Q <= 0 || L <= 0) return static_cast<int>(cudaSuccess);
  const int l_blocks = (L + kWarps - 1) / kWarps;
  if (l_blocks > 65535 || D <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Q, l_blocks);
  const size_t smem = static_cast<size_t>((D + 3) / 4) * sizeof(float4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(beam_gather_f32_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    beam_gather_f32_kernel<true><<<grid, kThreads, smem, s>>>(
        q, ids, corpus, out, L, D, N);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(beam_gather_f32_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    beam_gather_f32_kernel<false><<<grid, kThreads, smem, s>>>(
        q, ids, corpus, out, L, D, N);
  }
  return static_cast<int>(cudaGetLastError());
}
