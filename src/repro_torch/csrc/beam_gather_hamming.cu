// Code-domain fused gather + Hamming distance for the BQ engine's
// wide-beam HNSW traversal, batched over queries.
//
// Replaces: src/repro/kernels/beam_gather.py, beam_gather_hamming_kernel
// (Pallas body _beam_hamming_kernel, DMA gather _gather_rows).  The JAX
// package calls that kernel under vmap, one query at a time; this one
// takes the batch:
//   q (Q, W) u32 x ids (Q, L) i32 x codes (N, W) u32 -> out (Q, L) i32,
//   out[q, l] = sum_w popcount(codes[ids[q, l], w] ^ q[q, w]).
// The port keeps packed words as int32 tensors holding the same bits; they
// arrive here as uint32_t.
//
// What bounds it on an H100: bytes.  Each id reads one W * 4-byte row
// (32 B at 256 bits) picked by a data-dependent id and does W XORs and
// popcounts; the floor is (unique rows + query words + ids + output) over
// 3.35 TB/s.
//
// Design: the TPU kernel DMAs TB rows into VMEM per grid step.  Here each
// thread owns one (query, id) pair and loads its row with 16-byte loads
// (two at W = 8), XORs it with the query's words, which the block keeps in
// shared memory (every lane reads the same word: a broadcast, no bank
// conflict), and sums __popc.  Integer arithmetic: the result is exact.
//
// The kernel allocates nothing, launches on the caller's stream and returns
// cudaGetLastError().  Ids are clamped to [0, N) as JAX's gather clamps
// them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
beam_gather_hamming_kernel(const uint32_t* __restrict__ q,
                           const int32_t* __restrict__ ids,
                           const uint32_t* __restrict__ codes,
                           int32_t* __restrict__ out, int L, int W, int N) {
  extern __shared__ uint32_t q_s[];
  const int qi = blockIdx.x;
  for (int w = threadIdx.x; w < W; w += kThreads)
    q_s[w] = q[static_cast<size_t>(qi) * W + w];
  __syncthreads();

  const int l = blockIdx.y * kThreads + threadIdx.x;
  if (l >= L) return;
  int row = ids[static_cast<size_t>(qi) * L + l];
  row = min(max(row, 0), N - 1);
  const uint32_t* x = codes + static_cast<size_t>(row) * W;
  int acc = 0;
  if constexpr (kVec4) {
    const uint4* x4 = reinterpret_cast<const uint4*>(x);
    for (int j = 0; j < (W >> 2); ++j) {
      const uint4 a = __ldg(x4 + j);
      acc += __popc(a.x ^ q_s[4 * j]) + __popc(a.y ^ q_s[4 * j + 1])
           + __popc(a.z ^ q_s[4 * j + 2]) + __popc(a.w ^ q_s[4 * j + 3]);
    }
  } else {
    for (int w = 0; w < W; ++w) acc += __popc(__ldg(x + w) ^ q_s[w]);
  }
  out[static_cast<size_t>(qi) * L + l] = acc;
}

}  // namespace

extern "C" int beam_gather_hamming_u32(const uint32_t* q, const int32_t* ids,
                                       const uint32_t* codes, int32_t* out,
                                       int Q, int L, int W, int N,
                                       void* stream) {
  if (Q <= 0 || L <= 0) return static_cast<int>(cudaSuccess);
  const int l_blocks = (L + kThreads - 1) / kThreads;
  if (l_blocks > 65535 || W <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Q, l_blocks);
  const size_t smem = static_cast<size_t>(W) * sizeof(uint32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((W & 3) == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0)
    beam_gather_hamming_kernel<true><<<grid, kThreads, smem, s>>>(
        q, ids, codes, out, L, W, N);
  else
    beam_gather_hamming_kernel<false><<<grid, kThreads, smem, s>>>(
        q, ids, codes, out, L, W, N);
  return static_cast<int>(cudaGetLastError());
}
