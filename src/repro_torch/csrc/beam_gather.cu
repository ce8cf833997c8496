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
//
// ---------------------------------------------------------------------------
// Fourth entry, beam_gather_step_f32: B1ˢ, B1's gather-distance with the
// HNSW layer-0 step around it, one launch a step.
//
// Computes: one iteration of the lockstep wide-beam loop of
// core/hnsw_search.py (the plain step, kernels/beam_gather.py
// beam_gather_step_ref) for every active query, in place on the search's
// state: pop the width smallest unexpanded candidates (topk_smallest's
// key, lowest index on ties) and mark them expanded, the +inf surplus too;
// test-and-set the visited bits of their adj0 rows; B1's distance on the
// fresh slots; keep the ef smallest of [buffer, block] by topk_smallest's
// key; count the iteration and write the query's active flag.  The
// results, iteration counts and fresh slots are the plain step's, bit for
// bit, with B1 as its distance.
//
// What bounds it on an H100: bytes, and the latency of one query's chain.
// At the HNSW cell's shape (Q 1,024, ef 256, width 4, M0 32, D 128) a step
// reads ~77 fresh rows of 512 B a query, 4 adjacency rows of 128 B, ~77
// visited words and the candidate state (ef x 13 B, read and written): ~45
// KB a query, 46 MB a step, ~14 us at 3.35 TB/s.  The plain step took
// ~125 launches of PyTorch's small kernels a step.
//
// Design: one block of 256 threads a query, the step's state in shared
// memory (or, where that plan passes 47 KB, in a global workspace of the
// same layout, a plan a block: so every ef, width * M0 and D); a block
// whose query is inactive only counts itself.
//  - pop: width rounds of a block-wide minimum over the masked keys, each
//    thread scanning its ef / 256 of them, the popped ones flagged;
//  - visit: the slots 256 at a time; the first occurrence of an id in
//    row-major order is found by a hash (each id's lowest slot by
//    atomicMin), and only it takes one 64-bit atomicOr on the query's
//    visited word: fresh where the bit was clear.  On duplicate-free rows
//    (the graph's invariant) that is the plain step's row-by-row update;
//  - distance: the fresh slots compacted, each warp B1's arithmetic on 4
//    rows at once (b1_partials and b1_finish, shared with B1's entry);
//  - merge: the block's keys sorted by a bitonic network (a key a thread
//    in registers and shuffles up to 256 keys, in the plan's memory past
//    that), then each entry's place in the merged order is its place in
//    its own list plus the other list's keys below it, by a binary search
//    (the buffer is sorted: every merge leaves it so, and beam_state's
//    first buffer is);
//  - counts: each block adds its query's new active flag and fresh slots
//    to device counters; the last block to finish writes the step's
//    active count and the search's fresh total to a pinned host buffer,
//    so that the host's one wait a step reads them without a copy.
// It takes every shape with 1 <= width <= ef; beam_gather_step_work gives
// the workspace a shape needs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kWarps = 8;                 // ids per block, one warp each
constexpr int kThreads = kWarps * 32;

// B1's arithmetic, shared by its gather entry and B1ˢ (the step entry at
// the end of this file), so that the two cannot drift apart: lane `lane`'s
// partial of each of R rows against the query row in shared memory, the
// fmaf chain from 0 over the float4s (kVec; floats otherwise) lane,
// lane + 32, ...  The R rows' loads of one depth are issued together.
template <bool kL2, bool kVec, int R>
__device__ __forceinline__ void b1_partials(const float* const (&x)[R],
                                            const float* q_smem, int D,
                                            int lane, float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  if (kVec) {
    const float4* q4 = reinterpret_cast<const float4*>(q_smem);
    const int d4 = D >> 2;
    for (int i = lane; i < d4; i += 32) {
      float4 a[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        a[r] = __ldg(reinterpret_cast<const float4*>(x[r]) + i);
      const float4 b = q4[i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (kL2) {
          float t;
          t = a[r].x - b.x; acc[r] = fmaf(t, t, acc[r]);
          t = a[r].y - b.y; acc[r] = fmaf(t, t, acc[r]);
          t = a[r].z - b.z; acc[r] = fmaf(t, t, acc[r]);
          t = a[r].w - b.w; acc[r] = fmaf(t, t, acc[r]);
        } else {
          acc[r] = fmaf(a[r].x, b.x, acc[r]);
          acc[r] = fmaf(a[r].y, b.y, acc[r]);
          acc[r] = fmaf(a[r].z, b.z, acc[r]);
          acc[r] = fmaf(a[r].w, b.w, acc[r]);
        }
      }
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      float a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = __ldg(x[r] + i);
      const float b = q_smem[i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (kL2) {
          const float t = a[r] - b;
          acc[r] = fmaf(t, t, acc[r]);
        } else {
          acc[r] = fmaf(a[r], b, acc[r]);
        }
      }
    }
  }
}

// B1's butterfly (offsets 16 .. 1) over a warp's partials, and its sign:
// the distance, in every lane
template <bool kL2>
__device__ __forceinline__ float b1_finish(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return kL2 ? acc : -acc;
}

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
  const float* x[1] = {corpus + static_cast<size_t>(row) * D};

  float acc[1];
  if ((D & 3) == 0 && (reinterpret_cast<uintptr_t>(corpus) & 15) == 0)
    b1_partials<kL2, true, 1>(x, q_smem, D, lane, acc);
  else
    b1_partials<kL2, false, 1>(x, q_smem, D, lane, acc);
  const float v = b1_finish<kL2>(acc[0]);
  if (lane == 0) out[static_cast<size_t>(qi) * L + l] = v;
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

// ---------------------------------------------------------------------------
// beam_gather_step_f32: B1ˢ, one layer-0 step of the HNSW wide-beam search
// (see the note at the top)
// ---------------------------------------------------------------------------

namespace {

constexpr int kStepThreads = 256;
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kStepRows = 4;         // fresh rows a warp loads at once
// dynamic shared memory a block may take: 48 KB less the static arrays, so
// that no launch needs the opt-in attribute; a larger plan lives in the
// global workspace
constexpr size_t kStepSmemMax = 48 * 1024 - 1024;
// bexp's flags: expanded before the step, and popped in it
constexpr uint8_t kExpanded = 1, kPopped = 2;

// B1ˢ's per-query memory: the byte offset of each array, P (the block's
// keys sorted: a power of two >= width * M0, at least a warp) and TH (the
// first-occurrence hash's slots, 2P)
struct StepPlan {
  int P, TH;
  size_t q, bkey, bid, skey, hkey, hmin, nbr, dist, flist, node, bexp, fresh,
      bytes;
};

__host__ __device__ inline StepPlan step_plan(int ef, int L, int width,
                                              int D) {
  StepPlan s;
  s.P = 32;
  while (s.P < L) s.P <<= 1;
  s.TH = 2 * s.P;
  size_t o = 0;
  s.q = o;     o += static_cast<size_t>((D + 3) / 4) * 16;
  s.bkey = o;  o += static_cast<size_t>(ef) * 8;
  s.bid = o;   o += static_cast<size_t>(ef) * 8;
  s.skey = o;  o += static_cast<size_t>(s.P) * 8;
  s.hkey = o;  o += static_cast<size_t>(s.TH) * 4;
  s.hmin = o;  o += static_cast<size_t>(s.TH) * 4;
  s.nbr = o;   o += static_cast<size_t>(L) * 4;
  s.dist = o;  o += static_cast<size_t>(L) * 4;
  s.flist = o; o += static_cast<size_t>(L) * 4;
  s.node = o;  o += static_cast<size_t>(width) * 4;
  s.bexp = o;  o += static_cast<size_t>(ef);
  s.fresh = o; o += static_cast<size_t>(L);
  s.bytes = (o + 15) / 16 * 16;
  return s;
}

// order_key's float back: ordered() is its own inverse
__device__ __forceinline__ float key_value(long long key) {
  const int hi = static_cast<int>(key >> 32);
  return __int_as_float(hi ^ ((hi >> 31) & 0x7FFFFFFF));
}

// the entries of sorted a[0, n) below key
__device__ __forceinline__ int lower_bound(const long long* a, int n,
                                           long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long min_key(long long a, long long b) {
  return b < a ? b : a;
}

// the hash slot of id v among TH (a power of two)
__device__ __forceinline__ int hash_slot(int v, int TH) {
  return static_cast<int>((static_cast<unsigned>(v) * 0x9E3779B1u) >>
                          (33 - __ffs(TH)));
}

// one block a query; a block whose query is not active only counts itself.
// kSmem: the plan in shared memory, else at work + blockIdx.x * its bytes
template <bool kL2, bool kVec, bool kSmem>
__global__ void __launch_bounds__(kStepThreads, 4)
beam_gather_step_kernel(const float* __restrict__ q,
                        const int32_t* __restrict__ adj0,
                        const float* __restrict__ corpus,
                        float* __restrict__ cand_d,
                        long long* __restrict__ cand_id,
                        uint8_t* __restrict__ expanded,
                        unsigned long long* __restrict__ visited,
                        int32_t* __restrict__ iters,
                        uint8_t* __restrict__ active,
                        unsigned long long* __restrict__ counts,
                        long long* __restrict__ host_counts,
                        char* __restrict__ work, int ef, int M0, int width,
                        int D, int N, int n_adj, int n_words, int max_iters) {
  extern __shared__ float4 step_smem4[];
  __shared__ long long red[2][kStepWarps];
  __shared__ int wcnt[kStepWarps];
  const int qi = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int L = width * M0;
  const StepPlan pl = step_plan(ef, L, width, D);
  char* sm = kSmem ? reinterpret_cast<char*>(step_smem4)
                   : work + static_cast<size_t>(qi) * pl.bytes;
  float* q_s = reinterpret_cast<float*>(sm + pl.q);
  long long* bkey = reinterpret_cast<long long*>(sm + pl.bkey);
  long long* bid = reinterpret_cast<long long*>(sm + pl.bid);
  long long* skey = reinterpret_cast<long long*>(sm + pl.skey);
  int* hkey = reinterpret_cast<int*>(sm + pl.hkey);
  int* hmin = reinterpret_cast<int*>(sm + pl.hmin);
  int* nbr = reinterpret_cast<int*>(sm + pl.nbr);
  float* dist = reinterpret_cast<float*>(sm + pl.dist);
  int* flist = reinterpret_cast<int*>(sm + pl.flist);
  int* node = reinterpret_cast<int*>(sm + pl.node);
  uint8_t* bexp = reinterpret_cast<uint8_t*>(sm + pl.bexp);
  uint8_t* sfresh = reinterpret_cast<uint8_t*>(sm + pl.fresh);

  int n_fresh = 0;
  bool act_new = false;
  if (active[qi]) {
    const size_t row = static_cast<size_t>(qi) * ef;
    const int it = iters[qi] + 1;
    // ---- the query, the buffer's keys (topk_smallest's: ordered float
    // bits above the column), ids and flags; the hash emptied
    const float* q_row = q + static_cast<size_t>(qi) * D;
    for (int d = tid; d < D; d += kStepThreads) q_s[d] = q_row[d];
    for (int i = tid; i < ef; i += kStepThreads) {
      bkey[i] = order_key(cand_d[row + i], i);
      bid[i] = cand_id[row + i];
      bexp[i] = expanded[row + i] ? kExpanded : 0;
    }
    for (int h = tid; h < pl.TH; h += kStepThreads) {
      hkey[h] = kPad;
      hmin[h] = 0x7FFFFFFF;
    }
    __syncthreads();

    // ---- pop: the width smallest keys, expanded ones at +inf, one a
    // round; each is flagged popped (by the thread that scans its entry,
    // so the next round skips it), the +inf surplus too; its node where
    // its value is finite
    for (int w = 0; w < width; ++w) {
      long long m = kEmptyKey;
      for (int i = tid; i < ef; i += kStepThreads) {
        const uint8_t e = bexp[i];
        if (e != kPopped)
          m = min_key(m, e ? order_key(plus_inf(), i) : bkey[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = min_key(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) red[w & 1][warp] = m;
      __syncthreads();
      long long best = red[w & 1][0];
#pragma unroll
      for (int k = 1; k < kStepWarps; ++k) best = min_key(best, red[w & 1][k]);
      const int col = static_cast<int>(best & 0xFFFFFFFF);
      if (col % kStepThreads == tid) bexp[col] = kPopped;
      if (tid == 0)
        node[w] = isfinite(key_value(best)) ? static_cast<int>(bid[col])
                                            : kPad;
    }
    __syncthreads();

    // ---- visit: slot l = b * M0 + j of the popped rows; a neighbour is
    // fresh at its first occurrence in that order (the hash keeps each
    // id's lowest slot) if its visited bit was clear, which is the plain
    // step's row-by-row update on duplicate-free rows
    for (int l = tid; l < L; l += kStepThreads) {
      const int nd = node[l / M0];
      int nb = kPad;
      if (nd != kPad)
        nb = adj0[static_cast<size_t>(min(max(nd, 0), n_adj - 1)) * M0 +
                  l % M0];
      nbr[l] = nb;
      if (nb != kPad) {
        int hs = hash_slot(nb, pl.TH);
        for (;;) {
          const int prev = atomicCAS(&hkey[hs], kPad, nb);
          if (prev == kPad || prev == nb) break;
          hs = (hs + 1) & (pl.TH - 1);
        }
        atomicMin(&hmin[hs], l);
      }
    }
    __syncthreads();
    unsigned long long* vis = visited + static_cast<size_t>(qi) * n_words;
    for (int l0 = 0; l0 < L; l0 += kStepThreads) {
      const int l = l0 + tid;
      bool fresh = false;
      if (l < L) {
        const int nb = nbr[l];
        if (nb != kPad) {
          int hs = hash_slot(nb, pl.TH);
          while (hkey[hs] != nb) hs = (hs + 1) & (pl.TH - 1);
          if (hmin[hs] == l) {
            const int id = min(max(nb, 0), N - 1);
            const unsigned long long bit = 1ull << (id & 31);
            fresh = (atomicOr(vis + (id >> 5), bit) & bit) == 0;
          }
        }
        sfresh[l] = fresh;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, fresh);
      if (lane == 0) wcnt[warp] = __popc(bal);
      __syncthreads();
      int base = n_fresh;
#pragma unroll
      for (int k = 0; k < kStepWarps; ++k) {
        base += k < warp ? wcnt[k] : 0;
        n_fresh += wcnt[k];
      }
      if (fresh) flist[base + __popc(bal & ((1u << lane) - 1))] = l;
      __syncthreads();
    }

    // ---- distance: B1's arithmetic on the fresh rows alone, a warp
    // kStepRows rows at once
    for (int k0 = warp * kStepRows; k0 < n_fresh;
         k0 += kStepWarps * kStepRows) {
      const float* x[kStepRows];
#pragma unroll
      for (int r = 0; r < kStepRows; ++r) {
        const int l = flist[min(k0 + r, n_fresh - 1)];
        x[r] = corpus + static_cast<size_t>(min(max(nbr[l], 0), N - 1)) * D;
      }
      float acc[kStepRows];
      b1_partials<kL2, kVec, kStepRows>(x, q_s, D, lane, acc);
#pragma unroll
      for (int r = 0; r < kStepRows; ++r) {
        const float v = b1_finish<kL2>(acc[r]);
        if (lane == 0 && k0 + r < n_fresh) dist[flist[k0 + r]] = v;
      }
    }
    __syncthreads();

    // ---- merge: the block's keys (column ef + l, +inf where stale)
    // sorted by a bitonic network, then each entry's rank in [buffer,
    // block] is its rank in its own list plus the other list's keys below
    // it.  The buffer is sorted by its keys: every merge leaves it so, and
    // a query is active only with a finite candidate, so its first buffer
    // is [finite, +inf, ...]
    if (pl.P <= kStepThreads) {
      // a key a thread: shuffles below a warp's width, memory above
      long long x = kEmptyKey;
      if (tid < L)
        x = order_key(sfresh[tid] ? dist[tid] : plus_inf(), ef + tid);
      for (int k = 2; k <= pl.P; k <<= 1)
        for (int j = k >> 1; j > 0; j >>= 1) {
          long long y;
          if (j >= 32) {
            if (tid < pl.P) skey[tid] = x;
            __syncthreads();
            y = tid < pl.P ? skey[tid ^ j] : x;
            __syncthreads();
          } else {
            y = __shfl_xor_sync(0xffffffffu, x, j);
          }
          const bool keep_min = ((tid & j) == 0) == ((tid & k) == 0);
          x = keep_min ? min_key(x, y) : (y > x ? y : x);
        }
      if (tid < pl.P) skey[tid] = x;
    } else {
      // P / 256 keys a thread, each exchange in memory
      for (int i = tid; i < pl.P; i += kStepThreads)
        skey[i] = i < L ? order_key(sfresh[i] ? dist[i] : plus_inf(), ef + i)
                        : kEmptyKey;
      __syncthreads();
      for (int k = 2; k <= pl.P; k <<= 1)
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int i = tid; i < pl.P; i += kStepThreads) {
            const int p = i ^ j;
            if (p > i) {
              const long long a = skey[i], b = skey[p];
              if ((a > b) == ((i & k) == 0)) {
                skey[i] = b;
                skey[p] = a;
              }
            }
          }
          __syncthreads();
        }
    }
    __syncthreads();
    float* od = cand_d + row;
    long long* oi = cand_id + row;
    uint8_t* oe = expanded + row;
    bool live = false;        // an unexpanded finite candidate survives
    for (int i = tid; i < ef; i += kStepThreads) {
      const long long key = bkey[i];
      const int r = i + lower_bound(skey, L, key);
      if (r < ef) {
        const float v = key_value(key);
        const bool e = bexp[i] != 0;
        od[r] = v;
        oi[r] = bid[i];
        oe[r] = e;
        live |= !e && isfinite(v);
      }
    }
    for (int j = tid; j < L; j += kStepThreads) {
      const long long key = skey[j];
      const int r = j + lower_bound(bkey, ef, key);
      if (r < ef) {
        const int l = static_cast<int>(key & 0xFFFFFFFF) - ef;
        const float v = key_value(key);
        const bool f = sfresh[l] != 0;
        od[r] = v;
        oi[r] = f ? nbr[l] : -1;
        oe[r] = !f;
        live |= f && isfinite(v);
      }
    }
    live = __syncthreads_or(live);
    act_new = live && it < max_iters;
    if (tid == 0) {
      iters[qi] = it;
      active[qi] = act_new;
    }
  }

  // ---- counts: the block's, then the last block to finish writes the
  // step's active queries and the search's fresh slots to the host buffer
  // and clears the step's accumulators
  if (tid == 0) {
    if (act_new) atomicAdd(&counts[0], 1ull);
    if (n_fresh)
      atomicAdd(&counts[2], static_cast<unsigned long long>(n_fresh));
    __threadfence();
    if (atomicAdd(&counts[1], 1ull) == gridDim.x - 1) {
      __threadfence();
      host_counts[0] = static_cast<long long>(atomicAdd(&counts[0], 0ull));
      host_counts[1] = static_cast<long long>(atomicAdd(&counts[2], 0ull));
      counts[0] = 0;
      counts[1] = 0;
      __threadfence_system();
    }
  }
}

struct StepArgs {
  const float* q;
  const int32_t* adj0;
  const float* corpus;
  float* cand_d;
  long long* cand_id;
  uint8_t* expanded;
  unsigned long long* visited;
  int32_t* iters;
  uint8_t* active;
  unsigned long long* counts;
  long long* host_counts;
  char* work;
  int ef, M0, width, D, N, n_adj, n_words, max_iters;
};

template <bool kL2, bool kVec, bool kSmem>
int launch_step_in(const StepArgs& a, const StepPlan& pl, int Q,
                cudaStream_t s) {
  beam_gather_step_kernel<kL2, kVec, kSmem>
      <<<Q, kStepThreads, kSmem ? pl.bytes : 0, s>>>(
          a.q, a.adj0, a.corpus, a.cand_d, a.cand_id, a.expanded, a.visited,
          a.iters, a.active, a.counts, a.host_counts, a.work, a.ef, a.M0,
          a.width, a.D, a.N, a.n_adj, a.n_words, a.max_iters);
  return static_cast<int>(cudaGetLastError());
}

template <bool kL2, bool kVec>
int launch_step(const StepArgs& a, const StepPlan& pl, int Q,
                cudaStream_t s) {
  return pl.bytes <= kStepSmemMax
             ? launch_step_in<kL2, kVec, true>(a, pl, Q, s)
             : launch_step_in<kL2, kVec, false>(a, pl, Q, s);
}

}  // namespace

// the global workspace B1ˢ needs a query at (ef, width, M0, D), in bytes:
// 0 where its plan fits in shared memory
extern "C" long long beam_gather_step_work(int ef, int width, int M0,
                                           int D) {
  const StepPlan pl = step_plan(ef, width * M0, width, D);
  return pl.bytes <= kStepSmemMax ? 0 : static_cast<long long>(pl.bytes);
}

// the device's address of a pinned host buffer (the step's counts land
// there); an error where the buffer is not mapped
extern "C" int beam_gather_step_host_ptr(void* host, void** dev) {
  return static_cast<int>(cudaHostGetDevicePointer(dev, host, 0));
}

// the host's one wait a step: the stream's work done, the counts landed
extern "C" int beam_gather_step_wait(void* stream) {
  return static_cast<int>(
      cudaStreamSynchronize(static_cast<cudaStream_t>(stream)));
}

// one layer-0 step of every query of the batch, in place on the search's
// state: cand_d (Q, ef) f32, cand_id (Q, ef) i64, expanded (Q, ef) u8,
// visited (Q, n_words) 64-bit words holding 32 bits each, iters (Q,) i32,
// active (Q,) u8; counts (4,) u64 on the device (zero at the search's
// start), host_counts (2,) i64 the device's address of pinned host memory:
// [active queries after the step, fresh slots of the search so far]; work
// Q x beam_gather_step_work(...) bytes where that is not 0 (else unread)
extern "C" int beam_gather_step_f32(
    const float* q, const int32_t* adj0, const float* corpus, float* cand_d,
    long long* cand_id, uint8_t* expanded, unsigned long long* visited,
    int32_t* iters, uint8_t* active, unsigned long long* counts,
    long long* host_counts, void* work, int Q, int ef, int M0, int width,
    int D, int N, int n_adj, int n_words, int max_iters, int mode,
    void* stream) {
  if (Q <= 0) return static_cast<int>(cudaSuccess);
  if (ef < 1 || width < 1 || width > ef || M0 < 1 ||
      static_cast<long long>(width) * M0 > (1 << 30) || D <= 0 || N <= 0 ||
      n_adj <= 0 || n_words != (N + 31) / 32 || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const StepPlan pl = step_plan(ef, width * M0, width, D);
  if (pl.bytes > kStepSmemMax && work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const StepArgs a{q, adj0, corpus, cand_d, cand_id, expanded, visited,
                   iters, active, counts, host_counts,
                   static_cast<char*>(work), ef, M0, width, D, N, n_adj,
                   n_words, max_iters};
  const bool vec =
      (D & 3) == 0 && (reinterpret_cast<uintptr_t>(corpus) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    return vec ? launch_step<true, true>(a, pl, Q, s)
               : launch_step<true, false>(a, pl, Q, s);
  return vec ? launch_step<false, true>(a, pl, Q, s)
             : launch_step<false, false>(a, pl, Q, s);
}
