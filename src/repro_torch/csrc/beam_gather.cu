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
//
// ---------------------------------------------------------------------------
// Third entry, beam_gather_lists_topk_f32: the second with the candidates'
// top-k fused in, what core/ivf.py's card path runs for k <= 100.
//
// Computes: topk_smallest (core/flat.py) of the second entry's (Q, P * M)
// output without writing it: for each (query, rank j) entry the kl =
// min(k, M) smallest 64-bit keys (order-preserving float bits above the
// column j * M + r) of its list's slots, +inf on PAD and past list_len,
// into cand (Q, P, kl); the wrapper merges a query's P * kl keys with one
// selection.  Its distances are the second entry's, bit for bit (the same
// per-thread tree), so they are B1's.
//
// What bounds it on an H100: at G's shape (Q 1,024, P 32, M 1,465, D 128)
// the fp32 work on the live slots, ~32 M pairs x 128 x 3 flops, 0.19 ms at
// 67 TFLOP/s, against ~0.16 ms of bytes (the unique rows once, the
// queries, probe, lists and the (Q, P, k) keys).  The second entry's
// stage split (scripts/lists_stage_cycles.py, PERF.md) puts the time in
// the arithmetic, not the copies: rows alone 32 % of it, the +inf fill
// and the stores 11 %; the (Q, P * M) matrix it writes (192 MB) and the
// top-k over it took three times the kernel.  Tensor cores stay out for
// the reason above.
//
// Design: the second entry's schedule and tiles (a block a list and 32 of
// its queries, 8 past D = 356), the lists taken longest first (the wrapper's
// `order`), so that the grid's tail is its shortest blocks, and no
// __syncthreads in the loop:
//  - a producer warp fills a ring of 2-4 stages of rows (2 where two blocks
//    fit an SM, as at D = 128): per live row one bulk asynchronous copy
//    (cp.async.bulk: 16-byte aligned rows, D % 4 == 0) completing its
//    bytes on the stage's "full" mbarrier, lane 0 first arriving with the
//    stage's byte count; other rows by 4-byte cp.async and
//    cp.async.mbarrier.arrive; it refills a stage once the consumer warps
//    arrive on its "empty" mbarrier;
//  - eight consumer warps run the second entry's register tile (4 queries
//    x 2 rows a thread, B1's tree) on each arrived stage and release it;
//    warps whose queries all lie past a partial tile's last leave at once;
//  - each consumer warp keeps its queries' lists of kl keys in registers
//    across its lanes: the first 32 slots of a list of at most 32 keys
//    sorted by a bitonic network, then a slot whose key is below the
//    list's kl-th survives (a ballot) and the survivors go in one at a
//    time (an insertion by ballot and shuffle), each raising the kl-th,
//    which drops the survivors above it (l2_topk's threshold rule).  At the
//    end a list with fewer live slots than kl takes +inf keys at the
//    columns from list_len on, the next smallest.
// Past D = 796 the rows come from global memory (no ring).  k up to 32
// keeps one chunk of keys a lane, up to 128 four.  Tried and measured
// slower on G's batches (PERF.md): one selector warp fed the consumers'
// distance tiles through shared memory (the selection then ran serially),
// a radix-selected first bound, merging a ballot's survivors at once, and
// the warp's queries' insertions interleaved round by round.

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

// ---------------------------------------------------------------------------
// beam_gather_lists_topk_f32: the list-major entry with the candidates'
// top-k fused in (see the note at the top)
// ---------------------------------------------------------------------------

namespace {

constexpr int kTopkConsumers = kListThreads;  // warps 0-7: the arithmetic
constexpr int kTopkProducer = kListWarps;     // warp 8: the rows' copies
constexpr int kTopkThreads = kTopkConsumers + 32;
constexpr int kTopkMaxRing = 4;
constexpr int kTopkChunks = 4;   // a query's list: up to 32 * 4 keys
constexpr long long kEmptyKey = 0x7FFFFFFFFFFFFFFFLL;   // above every key

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count));
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* b, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred P;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return ok != 0;
}

// a phase that has not completed in 2^35 clocks (~17 s) is a deadlock:
// trap, so that the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  if (mbar_try_wait(b, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(b, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b))
               : "memory");
}

// arrive, and expect `bytes` more of asynchronous copies this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}

// one bulk asynchronous copy global -> shared (16-byte aligned ends, a
// multiple of 16 bytes), completing its bytes on mbarrier b
__device__ __forceinline__ void bulk_g2s(float* dst, const float* src,
                                         int bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// mbarrier b counts one arrival when this thread's earlier cp.async copies
// have landed (its initial count includes that arrival)
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(b))
               : "memory");
}

// the consumer warps meet here (barrier 0 is __syncthreads')
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kTopkConsumers) : "memory");
}

// float bits -> int32 in the same order: -0.0 below +0.0, NaN above +inf
__device__ __forceinline__ int ordered(float d) {
  const int b = __float_as_int(d);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

// core/flat.py's topk_smallest key: the float's bits in order in the high
// word, the column in the low word
__device__ __forceinline__ long long order_key(float d, int col) {
  return (static_cast<long long>(ordered(d)) << 32) |
         static_cast<long long>(static_cast<uint32_t>(col));
}

// the warp's 32 keys (one a lane) in ascending order across the lanes: a
// bitonic sort, 15 exchange steps by shuffle
__device__ __forceinline__ long long warp_sort(long long x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const long long y = __shfl_xor_sync(0xffffffffu, x, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      x = keep_min ? (y < x ? y : x) : (y > x ? y : x);
    }
  return x;
}

// a warp's ascending list of up to 32 * KC keys, position 32 c + lane in
// v[c] of that lane; unused positions hold kEmptyKey
template <int KC>
struct WarpList {
  long long v[KC];

  // the key at position p, in every lane
  __device__ __forceinline__ long long at(int p) const {
    long long x = v[0];
#pragma unroll
    for (int c = 1; c < KC; ++c)
      if (c == (p >> 5)) x = v[c];
    return __shfl_sync(0xffffffffu, x, p & 31);
  }

  // insert key (the same in every lane, not in the list): the keys below
  // it keep their places, the rest move up one
  __device__ __forceinline__ void insert(long long key, int lane) {
    int pos = 0;
#pragma unroll
    for (int c = 0; c < KC; ++c)
      pos += __popc(__ballot_sync(0xffffffffu, v[c] < key));
    long long last[KC], up[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      last[c] = __shfl_sync(0xffffffffu, v[c], 31);
      up[c] = __shfl_up_sync(0xffffffffu, v[c], 1);
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const long long prev = lane > 0 ? up[c] : (c > 0 ? last[c - 1] : key);
      const int p = 32 * c + lane;
      v[c] = p < pos ? v[c] : (p == pos ? key : prev);
    }
  }
};

// TQ of the fused entry: the wide tile where its ring of two stages fits in
// shared memory, else the narrow one (the matrix entry's rule)
inline int topk_tile_q(int D) { return list_tile_q(D); }

// dynamic shared memory: the queries and the ring of rows
inline size_t topk_smem(int tq, int tr, int D, int ring) {
  return static_cast<size_t>(tq + ring * tr) * list_stride(D) * sizeof(float);
}

// kStage cuts the kernel for scripts/lists_stage_cycles.py: 0 the schedule
// alone, 1 and the ring, 2 and the arithmetic (no selection), 3 the whole
// kernel (the only one the entry launches)
template <int A, int B, bool kVec, bool kOne, bool kStaged, int KC,
          int kStage>
__global__ void __launch_bounds__(kTopkThreads,
                                  A * B > 1 && KC == 1 ? 2 : 1)
beam_gather_lists_topk_kernel(const float* __restrict__ q,
                              const int32_t* __restrict__ entries,
                              const int32_t* __restrict__ starts,
                              const int32_t* __restrict__ tile_end,
                              const int32_t* __restrict__ order,
                              const int32_t* __restrict__ lists,
                              const int32_t* __restrict__ list_len,
                              const float* __restrict__ corpus,
                              long long* __restrict__ cand, int P, int M,
                              int D, int N, int nlist, int kl, int ring_n) {
  constexpr int TQ = kListWarps * A;
  constexpr int TR = 32 * B;
  extern __shared__ float4 topk_smem4[];
  __shared__ int ent_s[TQ];
  __shared__ __align__(8) uint64_t full[kTopkMaxRing];
  __shared__ __align__(8) uint64_t empty[kTopkMaxRing];

  // the block's list and tile: the first place in `order` whose tile_end
  // exceeds the block's index (the lists longest first, so the grid's
  // last blocks are its shortest)
  const int blk = blockIdx.x;
  int lo = 0, hi = nlist;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tile_end[mid] > blk) hi = mid; else lo = mid + 1;
  }
  if (lo == nlist) return;                       // past the last tile
  const int lst = order[lo];
  const int first = starts[lst], count = starts[lst + 1] - first;
  const int t = blk - (tile_end[lo] - (count + TQ - 1) / TQ);
  const int ne = min(TQ, count - t * TQ);
  const int R = min(max(list_len[lst], 0), M);
  const int32_t* ids = lists + static_cast<size_t>(lst) * M;
  const int n_stages = (R + TR - 1) / TR;
  // the consumer warps that hold a query of this tile; the others leave
  const int n_active = min(kListWarps, (ne + A - 1) / A);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int stride = list_stride(D);
  float* q_s = reinterpret_cast<float*>(topk_smem4);
  float* ring = q_s + TQ * stride;

  if (kStaged && tid == 0) {
    for (int s = 0; s < ring_n; ++s) {
      mbar_init(&full[s], kVec ? 1 : 32);
      mbar_init(&empty[s], n_active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < TQ; i += kTopkThreads)
    ent_s[i] = i < ne ? entries[first + t * TQ + i] : -1;
  __syncthreads();
  if (kStage == 0) return;

  if (warp == kTopkProducer) {
    // ------------------------------------------------------- producer
    if (!kStaged) return;
    for (int s = 0; s < n_stages; ++s) {
      const int slot = s % ring_n, ph = (s / ring_n) & 1;
      mbar_wait(&empty[slot], ph ^ 1);
      float* stage = ring + slot * TR * stride;
      const int r0 = s * TR, nr = min(TR, R - r0);
      if constexpr (kVec) {
        // one bulk copy a live row, its bytes expected first
        int id[B], n_live = 0;
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const int i = lane + 32 * b;
          id[b] = i < nr ? ids[r0 + i] : kPad;
          n_live += __popc(__ballot_sync(0xffffffffu, id[b] != kPad));
        }
        if (lane == 0) mbar_expect_tx(&full[slot], n_live * D * 4);
        __syncwarp();
#pragma unroll
        for (int b = 0; b < B; ++b)
          if (id[b] != kPad)
            bulk_g2s(stage + (lane + 32 * b) * stride,
                     corpus +
                         static_cast<size_t>(min(max(id[b], 0), N - 1)) * D,
                     D * 4, &full[slot]);
      } else {
        // rows that bulk copies cannot take: 4-byte cp.async, then one
        // arrival a lane once its copies have landed
        for (int i = lane; i < nr * D; i += 32) {
          const int r = i / D, c = i - r * D;
          const int id = ids[r0 + r];
          if (id == kPad) continue;
          cp_async4_ca(stage + r * stride + c,
                       corpus + static_cast<size_t>(min(max(id, 0), N - 1)) * D
                           + c);
        }
        cp_async_arrive_noinc(&full[slot]);
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  if (kStaged) {
    for (int i = tid; i < TQ * D; i += kTopkConsumers) {
      const int qt = i / D, d = i - qt * D;
      q_s[qt * stride + d] =
          qt < ne ? q[static_cast<size_t>(ent_s[qt] / P) * D + d] : 0.f;
    }
    consumers_sync();
  }
  if (warp >= n_active) return;

  const float* qr[A];
  int qent[A], colbase[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int qt = warp * A + a;
    qent[a] = ent_s[qt];
    colbase[a] = qent[a] >= 0 ? (qent[a] % P) * M : 0;
    qr[a] = kStaged ? q_s + qt * stride
                    : q + static_cast<size_t>(qt < ne ? qent[a] / P : 0) * D;
  }
  WarpList<KC> top[A];
  long long thr[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
#pragma unroll
    for (int c = 0; c < KC; ++c) top[a].v[c] = kEmptyKey;
    thr[a] = kEmptyKey;
  }

  for (int s = 0; s < n_stages; ++s) {
    const int r0 = s * TR;
    const int slot = kStaged ? s % ring_n : 0;
    const float* stage = ring + slot * TR * stride;
    if (kStaged) mbar_wait(&full[slot], (s / ring_n) & 1);
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
    float res[A][B];
    if (kStage >= 2)
      pair_tile<A, B, kVec, kOne, kStaged>(qr, xr, D, res,
                                     std::make_integer_sequence<int, 32>{});
    if (kStaged) {                 // the stage's rows are read: release it
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    if (kStage == 2) {
      // keep the arithmetic: a store where a distance has NaN bits of the
      // run's own choosing, which none has
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int b = 0; b < B; ++b)
          if (__float_as_int(res[a][b]) == (0x7fc00000 | kl)) cand[0] = 0;
    }
    if (kStage < 3) continue;
    // the selection: a slot enters its query's list if its key is below
    // the list's kl-th; the lanes' survivors go in one at a time, each
    // raising the kl-th, which drops the survivors above it.  A list of at
    // most 32 keys starts as the first 32 slots sorted across the warp
#pragma unroll
    for (int a = 0; a < A; ++a) {
      if (qent[a] < 0) continue;
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int r = r0 + lane + 32 * b;
        const float v = rid[b] == kPad ? plus_inf() : res[a][b];
        const long long key = order_key(v, colbase[a] + r);
        if (KC == 1 && s == 0 && b == 0) {
          const long long sorted = warp_sort(r < R ? key : kEmptyKey, lane);
          top[a].v[0] = lane < kl ? sorted : kEmptyKey;
          thr[a] = top[a].at(kl - 1);
          continue;
        }
        unsigned m = __ballot_sync(0xffffffffu, r < R && key < thr[a]);
        while (m) {
          const int src = __ffs(m) - 1;
          top[a].insert(__shfl_sync(0xffffffffu, key, src), lane);
          thr[a] = top[a].at(kl - 1);
          m = (m & (m - 1)) &
              __ballot_sync(0xffffffffu, r < R && key < thr[a]);
        }
      }
    }
  }
  if (kStage < 3) return;

  // each query's kl keys; a list with fewer live slots than kl takes its
  // next smallest keys, +inf at the columns from R on
#pragma unroll
  for (int a = 0; a < A; ++a) {
    if (qent[a] < 0) continue;
    int filled = 0;
#pragma unroll
    for (int c = 0; c < KC; ++c)
      filled += __popc(__ballot_sync(0xffffffffu, top[a].v[c] != kEmptyKey));
    long long* o = cand + static_cast<size_t>(qent[a]) * kl;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const int p = 32 * c + lane;
      if (p < kl)
        o[p] = top[a].v[c] != kEmptyKey
                   ? top[a].v[c]
                   : order_key(plus_inf(), colbase[a] + R + p - filled);
    }
  }
}

template <int A, int B, bool kVec, bool kOne, bool kStaged, int KC,
          int kStage = 3>
int launch_topk(const float* q, const int32_t* entries, const int32_t* starts,
                const int32_t* tile_end, const int32_t* order,
                const int32_t* lists,
                const int32_t* list_len, const float* corpus,
                long long* cand, int P, int M, int D, int N, int nlist,
                int kl, int ring_n, int blocks, size_t smem,
                cudaStream_t s) {
  auto kernel =
      beam_gather_lists_topk_kernel<A, B, kVec, kOne, kStaged, KC, kStage>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  kernel<<<blocks, kTopkThreads, smem, s>>>(q, entries, starts, tile_end,
                                            order, lists, list_len, corpus,
                                            cand, P, M, D, N, nlist, kl,
                                            ring_n);
  return static_cast<int>(cudaGetLastError());
}

// the ring's depth: the deepest (2 to 4 stages) that keeps two blocks an
// SM where two fit with two stages, else the deepest that fits one
inline int topk_ring(int tq, int tr, int D) {
  const size_t two = (kListSmemMax + 1024) / 2 - 1024;
  int best = 0;
  for (int r = 2; r <= kTopkMaxRing; ++r)
    if (topk_smem(tq, tr, D, r) <= two) best = r;
  if (best) return best;
  for (int r = 2; r <= kTopkMaxRing; ++r)
    if (topk_smem(tq, tr, D, r) <= kListSmemMax) best = r;
  return best;
}

template <int KC>
int dispatch_topk(const float* q, const int32_t* entries,
                  const int32_t* starts, const int32_t* tile_end,
                  const int32_t* order, const int32_t* lists,
                  const int32_t* list_len,
                  const float* corpus, long long* cand, int P, int M, int D,
                  int N, int nlist, int kl, int blocks, bool vec,
                  cudaStream_t s) {
#define TOPK_ARGS q, entries, starts, tile_end, order, lists, list_len, \
    corpus, cand, P, M, D, N, nlist, kl
  const int tq = topk_tile_q(D);
  if (tq == kListWarps * kWideA) {
    const int tr = 32 * kWideB;
    const int rn = topk_ring(tq, tr, D);
    const size_t smem = topk_smem(tq, tr, D, rn);
    if (rn < 2) return static_cast<int>(cudaErrorInvalidValue);
    if (vec && D == 128)
      return launch_topk<kWideA, kWideB, true, true, true, KC>(
          TOPK_ARGS, rn, blocks, smem, s);
    return vec ? launch_topk<kWideA, kWideB, true, false, true, KC>(
                     TOPK_ARGS, rn, blocks, smem, s)
               : launch_topk<kWideA, kWideB, false, false, true, KC>(
                     TOPK_ARGS, rn, blocks, smem, s);
  }
  const int rn = topk_ring(tq, 32, D);
  if (rn >= 2) {
    const size_t smem = topk_smem(tq, 32, D, rn);
    return vec ? launch_topk<1, 1, true, false, true, KC>(TOPK_ARGS, rn,
                                                          blocks, smem, s)
               : launch_topk<1, 1, false, false, true, KC>(TOPK_ARGS, rn,
                                                           blocks, smem, s);
  }
  // too wide to stage: the same tile from global memory, no ring
  return vec ? launch_topk<1, 1, true, false, false, KC>(TOPK_ARGS, 1,
                                                         blocks, 0, s)
             : launch_topk<1, 1, false, false, false, KC>(TOPK_ARGS, 1,
                                                          blocks, 0, s);
#undef TOPK_ARGS
}

}  // namespace

// cand (Q, P, kl) int64: for each (query, rank j) entry the kl = min(k, M)
// smallest topk_smallest keys of its list's slots (columns j * M + r, +inf
// on PAD and past list_len).  The schedule is the second entry's with the
// lists taken in `order` (tile_end summed in that order); the ring's
// depth is topk_ring's
extern "C" int beam_gather_lists_topk_f32(
    const float* q, const int32_t* entries, const int32_t* starts,
    const int32_t* tile_end, const int32_t* order, const int32_t* lists,
    const int32_t* list_len, const float* corpus, long long* cand, int Q,
    int P, int M, int D, int N, int nlist, int k, void* stream) {
  if (Q <= 0 || P <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  const int kl = k < M ? k : M;
  const int64_t tq = topk_tile_q(D);
  const int64_t blocks = (static_cast<int64_t>(Q) * P + tq - 1) / tq + nlist;
  if (D <= 0 || N <= 0 || nlist <= 0 || kl < 1 ||
      kl > 32 * kTopkChunks || static_cast<int64_t>(Q) * P > INT32_MAX ||
      static_cast<int64_t>(P) * M > INT32_MAX || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      (D & 3) == 0 && (reinterpret_cast<uintptr_t>(corpus) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  if (kl <= 32)
    return dispatch_topk<1>(q, entries, starts, tile_end, order, lists,
                            list_len, corpus, cand, P, M, D, N, nlist, kl,
                            nb, vec, s);
  return dispatch_topk<kTopkChunks>(q, entries, starts, tile_end, order,
                                     lists, list_len, corpus, cand, P, M, D,
                                     N, nlist, kl, nb, vec, s);
}
