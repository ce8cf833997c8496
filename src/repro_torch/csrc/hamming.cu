// Packed Hamming distance scan: every query's code against every corpus
// code.
//
// Replaces: src/repro/kernels/hamming.py, hamming_kernel (Pallas body
// _hamming_kernel):
//   q (Q, W) u32 x x (N, W) u32 -> out (Q, N) i32,
//   out[q, n] = sum_w popcount(q[q, w] ^ x[n, w]).
// The port keeps packed words as int32 tensors holding the same bits; they
// arrive here as uint32_t.
//
// What bounds it on an H100: operations.  It does Q * N * W popcounts
// against Q * N * 4 output bytes, W / 4 popcounts per output byte (2 at
// 256 bits).  The CUDA C++ Programming Guide's arithmetic-instruction
// throughput table gives population count 16 results per clock per SM for
// compute capability 9.0: 132 SMs x 16 x 1.98 GHz = 4.18e12 per second,
// which at 2 per byte is slower than writing the bytes at 3.35 TB/s.
//
// Design: the TPU kernel materialises a (TQ, TN, W) XOR slab in VMEM.
// Here a block takes 32 queries x 1,024 corpus rows: the queries' words sit
// in shared memory (every lane reads the same word: a broadcast, no bank
// conflict), and each of the 256 threads walks 4 rows, loads each row's
// W words into registers once, and for each of the 32 queries XORs,
// popcounts and writes out[q, n] (lanes on consecutive n: coalesced
// stores).  The register path is compiled for kW in {1, 2, 4, 8, 16} words
// and takes every W up to 16: a W between two of them runs at the next
// (the row's words past W are zeros in registers, the queries' zeros in
// shared memory, and popc(0 ^ 0) adds nothing).  Rows load as 16-byte
// vectors where W = kW is a multiple of 4 and the corpus is 16-byte
// aligned (W = 4: one load, W = 8: two, the database's 256-bit codes, and
// the "dims" layout's 128-bit halves), else a word at a time into
// registers.  Past 16 words a row is read from memory once per query.
// Integer arithmetic: the result is exact.
//
// The kernel allocates nothing, launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;
constexpr int kTQ = 32;

// kW > 0: the row's W <= kW words held in registers (kVec: kW / 4 16-byte
// loads, W == kW; else a word at a time, zeros past W), each query's words
// padded with zeros to kW in shared memory; kW == 0: any W, the row read
// from memory per query
template <int kW, bool kVec>
__global__ void __launch_bounds__(kThreads)
hamming_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x,
               int32_t* __restrict__ out, int Q, int N, int W) {
  extern __shared__ uint32_t q_s[];
  const int q0 = blockIdx.y * kTQ;
  const int nq = min(kTQ, Q - q0);
  const int qw_n = kW > 0 ? kW : W;            // shared words a query
  for (int e = threadIdx.x; e < nq * qw_n; e += kThreads) {
    const int qq = e / qw_n, w = e - qq * qw_n;
    q_s[e] = w < W ? q[static_cast<size_t>(q0 + qq) * W + w] : 0u;
  }
  __syncthreads();

  const int n_begin = static_cast<int>(blockIdx.x) * kRowsPerBlock;
  const int n_end = min(N, n_begin + kRowsPerBlock);
  for (int n = n_begin + static_cast<int>(threadIdx.x); n < n_end;
       n += kThreads) {
    const uint32_t* row = x + static_cast<size_t>(n) * W;
    int32_t* o = out + static_cast<size_t>(q0) * N + n;
    if constexpr (kW > 0) {
      uint32_t r[kW];
      if constexpr (kVec) {
        const uint4* row4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
        for (int j = 0; j < kW / 4; ++j) {
          const uint4 v = __ldg(row4 + j);
          r[4 * j] = v.x;
          r[4 * j + 1] = v.y;
          r[4 * j + 2] = v.z;
          r[4 * j + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int w = 0; w < kW; ++w) r[w] = w < W ? __ldg(row + w) : 0u;
      }
      for (int qq = 0; qq < nq; ++qq) {
        const uint32_t* qw = q_s + qq * kW;
        int acc = 0;
#pragma unroll
        for (int w = 0; w < kW; ++w) acc += __popc(r[w] ^ qw[w]);
        o[static_cast<size_t>(qq) * N] = acc;
      }
    } else {
      for (int qq = 0; qq < nq; ++qq) {
        const uint32_t* qw = q_s + qq * W;
        int acc = 0;
        for (int w = 0; w < W; ++w) acc += __popc(__ldg(row + w) ^ qw[w]);
        o[static_cast<size_t>(qq) * N] = acc;
      }
    }
  }
}

template <int kW, bool kVec>
int launch(const uint32_t* q, const uint32_t* x, int32_t* out, int Q, int N,
           int W, cudaStream_t s) {
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock,
                  (Q + kTQ - 1) / kTQ);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(kTQ) * (kW > 0 ? kW : W) * sizeof(uint32_t);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(hamming_kernel<kW, kVec>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  hamming_kernel<kW, kVec><<<grid, kThreads, smem, s>>>(q, x, out, Q, N, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hamming_u32(const uint32_t* q, const uint32_t* x, int32_t* out,
                           int Q, int N, int W, void* stream) {
  if (Q <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (W <= 0 || static_cast<size_t>(kTQ) * W * 4 > 200 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the register path's width: the least of 1, 2, 4, 8, 16 words that
  // holds W; 16-byte loads where it is W itself, a multiple of 4, and the
  // rows are aligned
  const int kw = W <= 1 ? 1 : W <= 2 ? 2 : W <= 4 ? 4 : W <= 8 ? 8
               : W <= 16 ? 16 : 0;
  const bool vec = kw == W && (W & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  switch (kw) {
    case 1: return launch<1, false>(q, x, out, Q, N, W, s);
    case 2: return launch<2, false>(q, x, out, Q, N, W, s);
    case 4: return vec ? launch<4, true>(q, x, out, Q, N, W, s)
                       : launch<4, false>(q, x, out, Q, N, W, s);
    case 8: return vec ? launch<8, true>(q, x, out, Q, N, W, s)
                       : launch<8, false>(q, x, out, Q, N, W, s);
    case 16: return vec ? launch<16, true>(q, x, out, Q, N, W, s)
                        : launch<16, false>(q, x, out, Q, N, W, s);
    default: return launch<0, false>(q, x, out, Q, N, W, s);
  }
}
