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
//
// ---------------------------------------------------------------------------
// Second entry, beam_gather_lists_f32: B1's l2 function where the IVF index
// runs it, list-major.
//
// Computes: src/repro/kernels/beam_gather.py, beam_gather_kernel, at IVF's
// shape.  The JAX package's _ivf_search computes these distances in plain
// jnp by the norm expansion (src/repro/core/ivf.py:126-133); the port's
// card path computed them with the entry above over the (Q, P * M) block
// of candidate ids lists[probe].  This entry takes the probe itself:
//   q (Q, D) f32 x probe (Q, P) i32 list ids x lists (nlist, M) i32 (PAD =
//   -1) x list_len (nlist,) i32 x corpus (N, D) f32 -> out (Q, P * M) f32,
//   out[q, j * M + r] = diff-square-sum of q and corpus[lists[probe[q, j],
//   r]], +inf where r >= list_len or that slot is PAD.
//
// What bounds it on an H100: at IVF's shape (Q 1,024, P 32, M 1,465, D 128)
// the entry above gives one block to a query, and every query re-reads the
// rows of its 32 lists: 24.6 GB of row reads a batch for ~0.5 GB of
// unique rows, 7.3 ms at 3.35 TB/s.  Here the floor is the unique rows
// read once plus the (Q, P * M) output (192 MB), ~0.2 ms, against the
// fp32 work: a subtract and an fma a live pair-element, ~0.25 ms for ~32 M
// live pairs.
//
// Design:
//  - Bookkeeping in the wrapper, on the device, with no host sync: the
//    (query, rank) entries of probe sorted stably by list, each list's
//    first entry (starts), and the inclusive prefix sum of its query
//    tiles, ceil(count / TQ) (tile_end).  The grid is a fixed
//    ceil(Q * P / TQ) + nlist blocks, an upper bound on the tiles; a block
//    finds its list by a binary search over tile_end and returns past the
//    last tile.  A popular list gets several tiles, a list no query
//    probes none.
//  - A block owns one list and a tile of TQ of its queries.  The queries
//    go to shared memory; the list's live rows (list_len) stream through a
//    two-stage ring of TR rows, each row gathered by id with 16-byte
//    cp.async (4-byte where D % 4 != 0 or the corpus is not 16-byte
//    aligned), so the next stage's loads overlap this stage's arithmetic.
//    Rows sit (D4 | 1) float4s apart (D4 = ceil(D / 4)), so the 32 lanes'
//    rows at one depth fall in distinct banks; all lanes of a warp read the
//    same query words (a broadcast).
//  - Each thread holds a register tile of A queries x B rows (lane = row,
//    warp = query group): A = 4, B = 2 (TQ 32, TR 64) where that ring fits
//    in shared memory (D <= 356), else A = B = 1 (TQ 8, TR 32), and where
//    even that does not fit (D > 796) the same tile reads rows and queries
//    from global memory (the queries a float at a time, so a query row
//    need not be 16-byte aligned).  Writes run along r, coalesced.  Slots
//    from list_len to M are written +inf without a row read; a PAD id
//    inside the live length gives +inf too.
//  - Bit-equal to the entry above in l2 mode.  There a pair's value is the
//    butterfly (__shfl_xor_sync, offsets 16 .. 1) over 32 lane partials,
//    lane l's partial the fmaf(t, t, acc) chain from 0 over the float4s
//    (or floats, on the scalar path) l, l + 32, ...  That tree is the
//    balanced pairwise sum of the partials in bit-reversed lane order (0,
//    16, 8, 24, 4, ...).  A thread here computes the partials in that
//    order and adds them pairwise on a 5-deep stack (a binary counter):
//    31 adds a pair, ~12 % over the 256 FP instructions of a pair at
//    D = 128.  Float addition commutes, so the operands' order is free.
//  - Tensor cores stay out: 3xTF32 on the norm expansion (as B5) would
//    break the equality with the entry above for little gain at
//    ~32-query x ~1,000-row tiles.
//
// Entries must lie in [0, nlist) (probe) and ids other than PAD in
// [0, N), clamped there as above; Q * P * M must stay under 2^31 (int32
// output offsets; the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

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

// ---------------------------------------------------------------------------
// beam_gather_lists_f32: the list-major entry (see the note at the top)
// ---------------------------------------------------------------------------

namespace {

constexpr int kPad = -1;
constexpr int kListThreads = 256;
constexpr int kListWarps = kListThreads / 32;
constexpr int kListStages = 2;
// a block's shared memory on Hopper (227 KB), less room for the static
// entry array
constexpr size_t kListSmemMax = 232448 - 1024;

__device__ __forceinline__ float plus_inf() { return __int_as_float(0x7f800000); }

__host__ __device__ constexpr int bitrev5(int x) {
  return ((x & 1) << 4) | ((x & 2) << 2) | (x & 4) | ((x & 8) >> 2) |
         ((x & 16) >> 4);
}

__host__ __device__ constexpr int trailing_ones(int x) {
  return (x & 1) ? 1 + trailing_ones(x >> 1) : 0;
}

// a staged row's stride in floats: an odd count of float4s, so that eight
// lanes' rows at one depth start in distinct 16-byte bank groups
__host__ __device__ inline int list_stride(int D) {
  return 4 * (((D + 3) / 4) | 1);
}

inline size_t list_smem(int tq, int tr, int D) {
  return static_cast<size_t>(tq + kListStages * tr) * list_stride(D) *
         sizeof(float);
}

// the wide tile: A queries x B rows a thread, 8 A queries x 32 B rows a
// stage
constexpr int kWideA = 4, kWideB = 2;

// TQ: the wide tile where its ring fits in shared memory, else the narrow
// one (A = B = 1: 8 queries, 32 rows)
inline int list_tile_q(int D) {
  return list_smem(kListWarps * kWideA, 32 * kWideB, D) <= kListSmemMax
             ? kListWarps * kWideA
             : kListWarps;
}

__device__ __forceinline__ void cp_async16_cg(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4_ca(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// rows r0 .. r0 + nrows - 1 of the list (ids) into `stage`, row i at
// stage + i * stride; PAD rows are skipped (their slots are written +inf)
template <bool kVec>
__device__ __forceinline__ void load_rows(float* stage,
                                          const int32_t* __restrict__ ids,
                                          const float* __restrict__ corpus,
                                          int r0, int nrows, int D, int N,
                                          int stride) {
  constexpr int kPer = kVec ? 4 : 1;
  const int per_row = D / kPer;
  for (int i = threadIdx.x; i < nrows * per_row; i += kListThreads) {
    const int r = i / per_row, c = i - r * per_row;
    const int id = ids[r0 + r];
    if (id == kPad) continue;
    const float* src =
        corpus + static_cast<size_t>(min(max(id, 0), N - 1)) * D + c * kPer;
    if (kVec)
      cp_async16_cg(stage + r * stride + c * 4, src);
    else
      cp_async4_ca(stage + r * stride + c, src);
  }
}

template <bool kSmem>
__device__ __forceinline__ float4 load4(const float* p, int i) {
  if (kSmem) return reinterpret_cast<const float4*>(p)[i];
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}

// a query's float4 i: from shared memory, or from global memory one float
// at a time (the query rows' alignment is unchecked; the values, and so
// the bits, are those of a float4 load)
template <bool kSmem>
__device__ __forceinline__ float4 load4_q(const float* p, int i) {
  if (kSmem) return reinterpret_cast<const float4*>(p)[i];
  p += 4 * i;
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

template <bool kSmem>
__device__ __forceinline__ float load1(const float* p, int i) {
  if (kSmem) return p[i];
  return __ldg(p + i);
}

// leaf `Leaf` of the butterfly's tree: lane bitrev5(Leaf)'s partial of
// every pair of the tile, B1's fmaf chain over the float4s (floats) that
// lane visits, pushed onto the pair's stack (a binary counter: a leaf with
// t trailing ones closes t pairwise sums).  kOne: D = 128, one float4 a
// lane, so the 32 leaves are straight-line code whose loads the compiler
// can issue ahead of the leaf before
template <int Leaf, int A, int B, bool kVec, bool kOne, bool kSmem>
__device__ __forceinline__ void tree_leaf(const float* const (&qr)[A],
                                          const float* const (&xr)[B], int D,
                                          float (&st)[A][B][6]) {
  constexpr int kLane = bitrev5(Leaf);
  float acc[A][B];
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int b = 0; b < B; ++b) acc[a][b] = 0.f;
  if (kVec) {
    const int d4 = kOne ? kLane + 1 : D >> 2;
    for (int i = kLane; i < d4; i += 32) {
      float4 xv[B], qv[A];
#pragma unroll
      for (int b = 0; b < B; ++b) xv[b] = load4<kSmem>(xr[b], i);
#pragma unroll
      for (int a = 0; a < A; ++a) qv[a] = load4_q<kSmem>(qr[a], i);
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int b = 0; b < B; ++b) {
          float t;
          t = xv[b].x - qv[a].x; acc[a][b] = fmaf(t, t, acc[a][b]);
          t = xv[b].y - qv[a].y; acc[a][b] = fmaf(t, t, acc[a][b]);
          t = xv[b].z - qv[a].z; acc[a][b] = fmaf(t, t, acc[a][b]);
          t = xv[b].w - qv[a].w; acc[a][b] = fmaf(t, t, acc[a][b]);
        }
    }
  } else {
    for (int i = kLane; i < D; i += 32) {
      float xv[B], qv[A];
#pragma unroll
      for (int b = 0; b < B; ++b) xv[b] = load1<kSmem>(xr[b], i);
#pragma unroll
      for (int a = 0; a < A; ++a) qv[a] = load1<kSmem>(qr[a], i);
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const float t = xv[b] - qv[a];
          acc[a][b] = fmaf(t, t, acc[a][b]);
        }
    }
  }
  constexpr int kUp = trailing_ones(Leaf);
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float v = acc[a][b];
#pragma unroll
      for (int k = 0; k < kUp; ++k) v = st[a][b][k] + v;
      st[a][b][kUp] = v;
    }
}

template <int A, int B, bool kVec, bool kOne, bool kSmem, int... Leaves>
__device__ __forceinline__ void pair_tile(const float* const (&qr)[A],
                                          const float* const (&xr)[B], int D,
                                          float (&res)[A][B],
                                          std::integer_sequence<int, Leaves...>) {
  float st[A][B][6];
  (tree_leaf<Leaves, A, B, kVec, kOne, kSmem>(qr, xr, D, st), ...);
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int b = 0; b < B; ++b) res[a][b] = st[a][b][5];
}

template <int A, int B, bool kVec, bool kOne, bool kStaged>
__global__ void __launch_bounds__(kListThreads, A * B > 1 ? 2 : 1)
beam_gather_lists_kernel(const float* __restrict__ q,
                         const int32_t* __restrict__ entries,
                         const int32_t* __restrict__ starts,
                         const int32_t* __restrict__ tile_end,
                         const int32_t* __restrict__ lists,
                         const int32_t* __restrict__ list_len,
                         const float* __restrict__ corpus,
                         float* __restrict__ out, int P, int M, int D, int N,
                         int nlist) {
  constexpr int TQ = kListWarps * A;
  constexpr int TR = 32 * B;
  extern __shared__ float4 lists_smem4[];
  __shared__ int ent_s[TQ];

  // the block's list: the first whose tile_end exceeds the block index
  const int blk = blockIdx.x;
  int lo = 0, hi = nlist;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tile_end[mid] > blk) hi = mid; else lo = mid + 1;
  }
  if (lo == nlist) return;                       // past the last tile
  const int lst = lo;
  const int first = starts[lst], count = starts[lst + 1] - first;
  const int t = blk - (tile_end[lst] - (count + TQ - 1) / TQ);
  const int ne = min(TQ, count - t * TQ);
  const int R = min(max(list_len[lst], 0), M);
  const int32_t* ids = lists + static_cast<size_t>(lst) * M;
  const int tid = threadIdx.x;
  const int stride = list_stride(D);
  float* q_s = reinterpret_cast<float*>(lists_smem4);
  float* ring = q_s + TQ * stride;
  const int n_stages = (R + TR - 1) / TR;

  if (kStaged && n_stages > 0) {
    load_rows<kVec>(ring, ids, corpus, 0, min(TR, R), D, N, stride);
    cp_commit_group();
  }
  for (int i = tid; i < TQ; i += kListThreads)
    ent_s[i] = i < ne ? entries[first + t * TQ + i] : -1;
  __syncthreads();
  // the slots past the live length: +inf, no row read (int32 offsets:
  // Q * P * M < 2^31)
  for (int e = 0; e < ne; ++e) {
    float* o = out + ent_s[e] * M;
    for (int r = R + tid; r < M; r += kListThreads) o[r] = plus_inf();
  }
  if (n_stages == 0) return;
  if (kStaged) {
    for (int i = tid; i < TQ * D; i += kListThreads) {
      const int qt = i / D, d = i - qt * D;
      q_s[qt * stride + d] =
          qt < ne ? q[static_cast<size_t>(ent_s[qt] / P) * D + d] : 0.f;
    }
  }

  const int warp = tid >> 5, lane = tid & 31;
  const float* qr[A];
  int qent[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int qt = warp * A + a;
    qent[a] = ent_s[qt];
    qr[a] = kStaged ? q_s + qt * stride
                    : q + static_cast<size_t>(qt < ne ? qent[a] / P : 0) * D;
  }
  for (int s = 0; s < n_stages; ++s) {
    const int r0 = s * TR;
    float* stage = ring + (s & 1) * TR * stride;
    if (kStaged) {
      if (s + 1 < n_stages) {
        load_rows<kVec>(ring + ((s + 1) & 1) * TR * stride, ids, corpus,
                        r0 + TR, min(TR, R - r0 - TR), D, N, stride);
        cp_commit_group();
        cp_wait_group<1>();
      } else {
        cp_wait_group<0>();
      }
      __syncthreads();
    }
    const float* xr[B];
    int rid[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int r = r0 + lane + 32 * b;
      rid[b] = r < R ? ids[r] : kPad;
      xr[b] = kStaged ? stage + (lane + 32 * b) * stride
                      : corpus + static_cast<size_t>(
                                     min(max(rid[b], 0), N - 1)) * D;
    }
    // a warp whose queries all lie past the tile's (a list's last, partial
    // tile) only keeps the barriers
    if (warp * A < ne) {
      float res[A][B];
      pair_tile<A, B, kVec, kOne, kStaged>(qr, xr, D, res,
                                     std::make_integer_sequence<int, 32>{});
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const int r = r0 + lane + 32 * b;
          if (qent[a] >= 0 && r < R)
            out[qent[a] * M + r] = rid[b] == kPad ? plus_inf() : res[a][b];
        }
    }
    if (kStaged) __syncthreads();          // before the ring slot refills
  }
}

template <int A, int B, bool kVec, bool kOne, bool kStaged>
int launch_lists(const float* q, const int32_t* entries,
                 const int32_t* starts, const int32_t* tile_end,
                 const int32_t* lists, const int32_t* list_len,
                 const float* corpus, float* out, int P, int M, int D, int N,
                 int nlist, int blocks, size_t smem, cudaStream_t s) {
  auto kernel = beam_gather_lists_kernel<A, B, kVec, kOne, kStaged>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  kernel<<<blocks, kListThreads, smem, s>>>(q, entries, starts, tile_end,
                                            lists, list_len, corpus, out, P,
                                            M, D, N, nlist);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// TQ, the queries of one list a block takes at width D: the wrapper cuts
// the probe's entries into tiles of this many
extern "C" int beam_gather_lists_tile_q(int D) { return list_tile_q(D); }

extern "C" int beam_gather_lists_f32(const float* q, const int32_t* entries,
                                     const int32_t* starts,
                                     const int32_t* tile_end,
                                     const int32_t* lists,
                                     const int32_t* list_len,
                                     const float* corpus, float* out, int Q,
                                     int P, int M, int D, int N, int nlist,
                                     void* stream) {
  if (Q <= 0 || P <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  const int64_t tq = list_tile_q(D);
  const int64_t blocks = (static_cast<int64_t>(Q) * P + tq - 1) / tq + nlist;
  if (D <= 0 || N <= 0 || nlist <= 0 ||
      static_cast<int64_t>(Q) * P * M > INT32_MAX || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      (D & 3) == 0 && (reinterpret_cast<uintptr_t>(corpus) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
#define LISTS_ARGS q, entries, starts, tile_end, lists, list_len, corpus, \
    out, P, M, D, N, nlist, nb
  if (tq == kListWarps * kWideA) {
    const size_t smem = list_smem(kListWarps * kWideA, 32 * kWideB, D);
    if (vec && D == 128)
      return launch_lists<kWideA, kWideB, true, true, true>(LISTS_ARGS, smem,
                                                            s);
    return vec ? launch_lists<kWideA, kWideB, true, false, true>(LISTS_ARGS,
                                                                 smem, s)
               : launch_lists<kWideA, kWideB, false, false, true>(LISTS_ARGS,
                                                                  smem, s);
  }
  const size_t smem = list_smem(kListWarps, 32, D);
  if (smem <= kListSmemMax)
    return vec ? launch_lists<1, 1, true, false, true>(LISTS_ARGS, smem, s)
               : launch_lists<1, 1, false, false, true>(LISTS_ARGS, smem, s);
  // too wide to stage: the same tile from global memory
  return vec ? launch_lists<1, 1, true, false, false>(LISTS_ARGS, 0, s)
             : launch_lists<1, 1, false, false, false>(LISTS_ARGS, 0, s);
#undef LISTS_ARGS
}
