// Fused candidate gather + pairwise distance matrix for the bulk HNSW
// build's Alg-4 diversification prune, batched over prune nodes.
//
// Replaces: src/repro/kernels/bulk_prune.py, pair_gather_kernel (Pallas
// body _pair_kernel).  The JAX package calls it under vmap over the prune
// batch; this one takes the batch:
//   ids (B, C) i32 x corpus (N, D) f32 -> out (B, C, C) f32,
//   mode 0 = max(|a|^2 + |b|^2 - 2 a.b, 0), mode 1 = -a.b.
//
// What bounds it on an H100: bytes at the main path's shapes.  A node
// gathers C rows of D * 4 bytes picked by data-dependent ids and writes
// C * C * 4 bytes; the output is symmetric, so the function needs only the
// C (C + 1) / 2 distinct dot products.  At C = 60, D = 128 that is 0.029 ms
// of fp32 FMA work for 4,096 nodes against 0.051 ms of bytes (unique rows
// read once, output written once); at D = 784 the FMAs bound it.  What
// held the first version back was the gather: one block per node staged a
// 32-wide slice with scalar 4-byte loads, waited at a barrier, ran 32 FMA
// steps and waited again, with no load in flight during the products, and
// it computed the whole C x C square.
//
// Design:
//  - A block of at most 128 threads takes `npb` nodes at once (3 at C = 60,
//    chosen so that its warps are nearly full), and one thread owns an 8 x 8
//    micro-tile of one node: rows g, g + G, ..., g + 7G against columns h,
//    h + G, ..., with G = ceil(C / 8).  Only the G (G + 1) / 2 micro-tiles
//    with g <= h are computed: tile (h, g) is tile (g, h) transposed, and
//    the diagonal tiles hold the row norms of the L2 epilogue.  Small
//    blocks, four to an SM, keep one block's gather in flight while
//    another computes or stores.
//  - The gather is asynchronous: each node's rows arrive in 16-float depth
//    slices through cp.async (16-byte copies, 4-byte where D % 4 != 0 or
//    the corpus is not 16-byte aligned; zero-filled past D) into a ring of
//    kStages slices, so the next slices' gathers are in flight while this
//    slice's products run.  Rows sit 80 bytes apart (a 16-byte pad), so
//    eight consecutive rows' words at one depth fall in distinct banks.
//  - The product loop reads one depth at a time (8 + 8 words for 64 FMAs),
//    which fits the 128 registers four blocks an SM allow; float4 reads
//    along the depth would hold 16 float4 a thread and spill there.
//  - The epilogue writes each entry and its mirror into shared memory
//    (reusing the ring), and the block then stores its nodes' contiguous
//    C * C blocks with coalesced 16-byte stores (scalar where C * C % 4 != 0).
//    Where that staging would take more than kStagedMax (C > 118), or
//    C needs several passes over its tiles (C > 120), threads store
//    directly.
//  - fp32 FMAs on the CUDA cores: every entry is one fmaf chain over
//    d = 0..D-1 from 0 (plus one + 0.f where D % 32 != 0, the zero padding
//    of the first version's 32-wide slices), so the output equals the first
//    version's bit for bit; fmaf(a, b, s) == fmaf(b, a, s) makes it exactly
//    symmetric with an exact-zero L2 diagonal.
//
// The kernel allocates nothing, launches on the caller's stream and returns
// cudaGetLastError().  Out-of-range ids are clamped to [0, N); callers pass
// valid ids.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 256;
constexpr int kMicro = 8;             // rows and columns of a micro-tile
constexpr int kSlice = 16;            // depth of one staged slice (floats)
constexpr int kStride = kSlice + 4;   // floats between staged rows
constexpr int kStages = 3;            // slices in the ring
constexpr int kMaxThreads = 128;
constexpr int kMaxNodes = 16;         // nodes a block takes at most
// the most shared memory a block takes for the output staging: with it,
// four blocks still fit on an SM (228 KB, less 1 KB the system reserves
// per block)
constexpr int kStagedMax = 56 * 1024;
constexpr int kMaxSmem = 227 * 1024;

struct Plan {
  int g;             // row groups: 8 * g >= C
  int tiles;         // g (g + 1) / 2 micro-tiles of a node
  int npb;           // nodes a block
  int passes;        // passes over a node's tiles
  int node_floats;   // a node's rows in one slice, padded
  int ring_floats;   // the ring (and the output staging it becomes)
  int slices;        // ceil(D / kSlice)
  int staged;        // 1: the output goes out through shared memory
};

// .ca (through L1), not .cg: the prune pads its invalid slots with row 0,
// and copies of one row from every block of an SM would otherwise all
// queue at one L2 slice
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// slice `s` of the block's nodes' rows into `stage`: row r of node k at
// stage + k * node_floats + r * kStride, zero past D
template <bool kVec>
__device__ __forceinline__ void load_slice(float* stage, const int* rows,
                                           const float* __restrict__ corpus,
                                           int nodes, int C, int D, int s,
                                           int node_floats) {
  constexpr int kPer = kVec ? 4 : 1;
  constexpr int kCopies = kSlice / kPer;
  const int d0 = s * kSlice;
  const int total = nodes * C * kCopies;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int q = e % kCopies;
    const int kr = e / kCopies;
    const int k = kr / C, r = kr - k * C;
    const float* row = corpus + static_cast<size_t>(rows[kr]) * D;
    const int d = d0 + q * kPer;
    float* dst = stage + k * node_floats + r * kStride + q * kPer;
    const bool in = d < D;
    if (kVec)
      cp_async16(dst, in ? row + d : row, in ? 16 : 0);
    else
      cp_async4(dst, in ? row + d : row, in ? 4 : 0);
  }
}

template <bool kL2, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 4)
pair_gather_f32_kernel(const int32_t* __restrict__ ids,
                       const float* __restrict__ corpus,
                       float* __restrict__ out, int B, int C, int D, int N,
                       Plan p) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* norms = ring + p.ring_floats;                 // npb * 8g
  int* rows = reinterpret_cast<int*>(norms + p.npb * kMicro * p.g);

  const int G = p.g;
  const int node0 = blockIdx.x * p.npb;
  const int nodes = min(p.npb, B - node0);
  for (int e = threadIdx.x; e < nodes * C; e += blockDim.x) {
    const int r = ids[static_cast<size_t>(node0) * C + e];
    rows[e] = min(max(r, 0), N - 1);
  }
  __syncthreads();

  for (int pass = 0; pass < p.passes; ++pass) {
    // this thread's node and micro-tile: diagonal tiles first, then the
    // tiles above the diagonal row by row
    const int u = threadIdx.x + pass * blockDim.x;
    const int k = u / p.tiles;
    const int t = u - k * p.tiles;
    const bool active = k < nodes;
    int ty = t, tx = t;
    if (t >= G) {
      int v = t - G;
      ty = 0;
      while (v >= G - 1 - ty) {
        v -= G - 1 - ty;
        ++ty;
      }
      tx = ty + 1 + v;
    }

    float acc[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

#pragma unroll 1
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < p.slices)
        load_slice<kVec>(ring + s * p.npb * p.node_floats, rows, corpus,
                         nodes, C, D, s, p.node_floats);
      cp_commit();
    }
#pragma unroll 1
    for (int s = 0; s < p.slices; ++s) {
      cp_wait<kStages - 2>();
      __syncthreads();
      const int nxt = s + kStages - 1;
      if (nxt < p.slices)
        load_slice<kVec>(ring + (nxt % kStages) * p.npb * p.node_floats,
                         rows, corpus, nodes, C, D, nxt, p.node_floats);
      cp_commit();
      if (active) {
        const float* base = ring + (s % kStages) * p.npb * p.node_floats
                            + k * p.node_floats;
#pragma unroll 4
        for (int c = 0; c < kSlice; ++c) {
          float a[kMicro], b[kMicro];
#pragma unroll
          for (int i = 0; i < kMicro; ++i)
            a[i] = base[(ty + G * i) * kStride + c];
#pragma unroll
          for (int j = 0; j < kMicro; ++j)
            b[j] = base[(tx + G * j) * kStride + c];
#pragma unroll
          for (int i = 0; i < kMicro; ++i)
#pragma unroll
            for (int j = 0; j < kMicro; ++j)
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
    cp_wait<0>();
    __syncthreads();                 // the ring is free from here on

    if (D & 31) {
      // the first version summed zero-padded 32-wide slices: fmaf(0, 0, s)
      // is s + 0.f, which turns a -0.f sum into +0.f
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], 0.f);
    }
    float* nk = norms + k * kMicro * G;
    if (kL2 && pass == 0) {
      // every diagonal tile is in the first pass (G <= blockDim.x)
      if (active && ty == tx) {
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
          if (ty + G * i < C) nk[ty + G * i] = acc[i][i];
      }
      __syncthreads();
    }

    const size_t cc = static_cast<size_t>(C) * C;
    float* o = p.staged ? ring + k * cc
                        : out + (static_cast<size_t>(node0) + k) * cc;
    if (active) {
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
        const int gi = ty + G * i;
        if (gi >= C) continue;
#pragma unroll
        for (int j = 0; j < kMicro; ++j) {
          const int gj = tx + G * j;
          if (gj >= C) continue;
          const float g = acc[i][j];
          const float v = kL2 ? fmaxf(nk[gi] + nk[gj] - 2.f * g, 0.f) : -g;
          o[gi * C + gj] = v;
          if (ty != tx) o[gj * C + gi] = v;
        }
      }
    }
    if (p.staged) {
      __syncthreads();
      // the block's nodes' C x C blocks are one contiguous run of out
      const size_t total = static_cast<size_t>(nodes) * cc;
      float* dst = out + static_cast<size_t>(node0) * cc;
      if ((cc & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
        const float4* src4 = reinterpret_cast<const float4*>(ring);
        float4* dst4 = reinterpret_cast<float4*>(dst);
        for (size_t e = threadIdx.x; e < total / 4; e += blockDim.x)
          dst4[e] = src4[e];
      } else {
        for (size_t e = threadIdx.x; e < total; e += blockDim.x)
          dst[e] = ring[e];
      }
    } else if (pass + 1 < p.passes) {
      __syncthreads();               // the next pass refills the ring
    }
  }
}

// the launch's plan: nodes a block and threads such that the warps are
// nearly full, and the shared memory it takes
Plan make_plan(int C, int D, int* threads, size_t* smem) {
  Plan p;
  p.g = (C + kMicro - 1) / kMicro;
  p.tiles = p.g * (p.g + 1) / 2;
  p.npb = 1;
  p.passes = 1;
  if (p.tiles <= kMaxThreads) {
    float best = 0.f;
    for (int npb = 1; npb <= kMaxNodes; ++npb) {
      const int th = (npb * p.tiles + 31) / 32 * 32;
      if (th > kMaxThreads) break;
      const float fill = static_cast<float>(npb * p.tiles) / th;
      if (fill > best) {
        best = fill;
        p.npb = npb;
        *threads = th;
      }
    }
  } else {
    p.passes = (p.tiles + kMaxThreads - 1) / kMaxThreads;
    *threads = ((p.tiles + p.passes - 1) / p.passes + 31) / 32 * 32;
  }
  p.node_floats = kMicro * p.g * kStride + 4;
  p.slices = (D + kSlice - 1) / kSlice;
  const int ring = kStages * p.npb * p.node_floats;
  const int staging = p.npb * C * C;
  const size_t extra = static_cast<size_t>(p.npb) * (kMicro * p.g + C) * 4;
  const size_t with_staging =
      static_cast<size_t>(ring > staging ? ring : staging) * 4 + extra;
  p.staged = p.passes == 1 && with_staging <= kStagedMax;
  p.ring_floats = p.staged && staging > ring ? staging : ring;
  *smem = static_cast<size_t>(p.ring_floats) * 4 + extra;
  return p;
}

template <bool kL2, bool kVec>
int launch(const int32_t* ids, const float* corpus, float* out, int B, int C,
           int D, int N, cudaStream_t s) {
  int threads = 0;
  size_t smem = 0;
  const Plan p = make_plan(C, D, &threads, &smem);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pair_gather_f32_kernel<kL2, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (B + p.npb - 1) / p.npb;
  kernel<<<grid, threads, smem, s>>>(ids, corpus, out, B, C, D, N, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pair_gather_f32(const int32_t* ids, const float* corpus,
                               float* out, int B, int C, int D, int N,
                               int mode, void* stream) {
  if (B <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  if (C > kMaxC || D <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (D & 3) == 0
      && (reinterpret_cast<uintptr_t>(corpus) & 15) == 0;
  if (mode == 0)
    return vec ? launch<true, true>(ids, corpus, out, B, C, D, N, s)
               : launch<true, false>(ids, corpus, out, B, C, D, N, s);
  return vec ? launch<false, true>(ids, corpus, out, B, C, D, N, s)
             : launch<false, false>(ids, corpus, out, B, C, D, N, s);
}
