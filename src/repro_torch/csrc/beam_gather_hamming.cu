// Code-domain fused gather + Hamming distance for the BQ engine's
// wide-beam HNSW traversal, batched over queries.
//
// Replaces: src/repro/kernels/beam_gather.py, beam_gather_hamming_kernel
// (Pallas body _beam_hamming_kernel, DMA gather _gather_rows).  The JAX
// package calls that kernel under vmap, one query at a time; this one
// takes the batch.  Two entries:
//   beam_gather_hamming_u32: the TPU function,
//     q (Q, W) u32 x ids (Q, L) i32 x codes (N, W) u32 -> out (Q, L) i32,
//     out[q, l] = sum_w popcount(codes[ids[q, l], w] ^ q[q, w]);
//   beam_gather_hamming_masked_u32: the BQ search step's fused form,
//     q (Q, W) u32 x ids (Q, L) i64 x fresh (Q, L) bool x codes (N, W) u32
//     -> out (Q, L) f32, the same count as a float where fresh is set and
//     +inf where it is not; a stale or PAD (-1) slot reads no row.  It
//     takes the beam's ids and mask as they are, so the step runs no
//     clamp, int32 cast, float cast or where around it.
// The port keeps packed words as int32 tensors holding the same bits; they
// arrive here as uint32_t.
//
// What bounds it on an H100: bytes, and at the search's shapes latency.
// Each slot reads one W * 4-byte row (32 B at 256 bits) picked by a
// data-dependent id and does W XORs and popcounts; the floor is (unique
// rows + query words + ids + output) over 3.35 TB/s, 1.5 us at Q = 1,024,
// L = 128 -- a single wave, so what sets the time is a kernel's launch in
// a CUDA graph (~1.1 us on an H100 80GB HBM3 at 700 W) and the random
// 32-byte row reads after the ids (PERF.md, scripts/hamming_stage_cycles.py).
//
// Design: the TPU kernel DMAs TB rows into VMEM per grid step.  Here a
// thread takes one (query, slot) pair of a flat grid over the Q * L pairs,
// so a short L (the entry point's L = 1) still fills whole blocks.  It
// issues its id load (and the mask's) first, then loads its query's words
// straight into registers -- a broadcast where a warp's pairs share a
// query -- so that only the row load waits on anything: two dependent
// round trips (id, then row), no shared memory and no barrier.  Two lanes
// a 32-byte row (one request a row) and four pairs a thread (eight row
// loads in flight) were slower on the card (the stage script keeps both).
// Integer arithmetic: the result is exact.
//
// The kernel allocates nothing, launches on the caller's stream and returns
// cudaGetLastError().  Ids are clamped to [0, N) as JAX's gather clamps
// them.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

// threads a block (the choice: PERF.md, from
// scripts/hamming_stage_cycles.py's sweep)
constexpr int kBlock = 256;

template <bool kMasked> struct Out { using type = int32_t; };
template <> struct Out<true> { using type = float; };

__device__ __forceinline__ int popc4(uint4 a, uint4 b) {
  return __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z)
       + __popc(a.w ^ b.w);
}

// p / L, in 32 bits where the pairs allow it
__device__ __forceinline__ long long query_of(long long p, int L,
                                              long long pairs) {
  return pairs <= 0xFFFFFFFFll
      ? static_cast<long long>(static_cast<unsigned>(p)
                               / static_cast<unsigned>(L))
      : p / L;
}

// A thread a (query, slot) pair.  kW = 8: 256-bit codes, the query's two
// 16-byte words loaded beside the id, then the row's two; kW = 0: W at run
// time, 16-byte loads where kVec4 (W % 4 == 0, q and codes 16-byte
// aligned), else 4-byte words.  IdT: int (the TPU entry) or long long
// (the masked one).
template <typename IdT, bool kMasked, int kW, bool kVec4, int kThreads>
__global__ void __launch_bounds__(kThreads)
beam_gather_hamming_kernel(const uint32_t* __restrict__ q,
                           const IdT* __restrict__ ids,
                           const uint8_t* __restrict__ fresh,
                           const uint32_t* __restrict__ codes,
                           typename Out<kMasked>::type* __restrict__ out,
                           long long pairs, int L, int W, int N) {
  const long long p =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= pairs) return;
  // the only loads the row waits for: its id (and, masked, its flag)
  long long row = static_cast<long long>(__ldg(ids + p));
  bool use = true;
  if constexpr (kMasked) use = __ldg(fresh + p) != 0;
  const long long qi = query_of(p, L, pairs);
  int acc = 0;
  if constexpr (kW == 8) {
    const uint4* q4 = reinterpret_cast<const uint4*>(q) + 2 * qi;
    const uint4 qa = __ldg(q4), qb = __ldg(q4 + 1);
    row = min(max(row, 0ll), static_cast<long long>(N) - 1);
    const uint4* x4 = reinterpret_cast<const uint4*>(codes) + 2 * row;
    if (use) acc = popc4(__ldg(x4), qa) + popc4(__ldg(x4 + 1), qb);
  } else if constexpr (kVec4) {
    row = min(max(row, 0ll), static_cast<long long>(N) - 1);
    const uint4* q4 = reinterpret_cast<const uint4*>(q + qi * W);
    const uint4* x4 = reinterpret_cast<const uint4*>(codes + row * W);
    if (use)
      for (int j = 0; j < (W >> 2); ++j)
        acc += popc4(__ldg(x4 + j), __ldg(q4 + j));
  } else {
    row = min(max(row, 0ll), static_cast<long long>(N) - 1);
    const uint32_t* qw = q + qi * W;
    const uint32_t* x = codes + row * W;
    if (use)
      for (int w = 0; w < W; ++w) acc += __popc(__ldg(x + w) ^ __ldg(qw + w));
  }
  if constexpr (kMasked)
    out[p] = use ? static_cast<float>(acc) : __int_as_float(0x7f800000);
  else
    out[p] = acc;
}

template <typename IdT, bool kMasked, int kThreads = kBlock>
cudaError_t launch_pairs(const uint32_t* q, const IdT* ids,
                         const uint8_t* fresh, const uint32_t* codes,
                         typename Out<kMasked>::type* out, int Q, int L,
                         int W, int N, cudaStream_t s) {
  if (Q <= 0 || L <= 0) return cudaSuccess;
  if (W <= 0 || N <= 0) return cudaErrorInvalidValue;
  const long long pairs = static_cast<long long>(Q) * L;
  const long long blocks = (pairs + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const bool vec = (W & 3) == 0
      && (reinterpret_cast<uintptr_t>(q) & 15) == 0
      && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec && W == 8)
    beam_gather_hamming_kernel<IdT, kMasked, 8, true, kThreads>
        <<<grid, kThreads, 0, s>>>(q, ids, fresh, codes, out, pairs, L, W, N);
  else if (vec)
    beam_gather_hamming_kernel<IdT, kMasked, 0, true, kThreads>
        <<<grid, kThreads, 0, s>>>(q, ids, fresh, codes, out, pairs, L, W, N);
  else
    beam_gather_hamming_kernel<IdT, kMasked, 0, false, kThreads>
        <<<grid, kThreads, 0, s>>>(q, ids, fresh, codes, out, pairs, L, W, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int beam_gather_hamming_u32(const uint32_t* q, const int32_t* ids,
                                       const uint32_t* codes, int32_t* out,
                                       int Q, int L, int W, int N,
                                       void* stream) {
  return static_cast<int>(launch_pairs<int, false>(
      q, ids, nullptr, codes, out, Q, L, W, N,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int beam_gather_hamming_masked_u32(const uint32_t* q,
                                              const long long* ids,
                                              const uint8_t* fresh,
                                              const uint32_t* codes,
                                              float* out, int Q, int L,
                                              int W, int N, void* stream) {
  return static_cast<int>(launch_pairs<long long, true>(
      q, ids, fresh, codes, out, Q, L, W, N,
      static_cast<cudaStream_t>(stream)));
}
