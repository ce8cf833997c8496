// Exact-scan distances on Hopper: the (Q, N) matrix, or each query's k
// nearest without the matrix.
//
// Replaces: src/repro/kernels/l2.py:62, l2_distance_kernel (Pallas body
// _l2_kernel): q (Q, D) f32 x x (N, D) f32 -> (Q, N) f32,
//   mode 0 (l2)     max(||q||^2 + ||x||^2 - 2 q.x, 0),
//   mode 1 (dot)    -q.x,
//   mode 2 (cosine) 1 + (-q.x), fused entry only (pairwise_cosine's
//                   1.0 + pairwise_dot on unit rows, rounded the same way).
// Two entries share one main loop and one epilogue arithmetic (`finish`,
// the mode compiled into each kernel):
//   l2_distance_f32 writes the matrix, with 64-bit output offsets;
//   l2_topk_f32 never writes it: each block keeps, per query row, the k
//   smallest 64-bit keys (order-preserving float bits above the column,
//   core/flat.py's topk_smallest key) of the corpus rows it walks, masked
//   rows at +inf, and writes them to cand (Q, splits, k); the wrapper
//   merges the splits.  Its distances are the matrix entry's, bit for bit.
//
// The product.  The cross term runs on the tensor cores in 3xTF32: each
// fp32 operand splits into big = tf32(a) (cvt.rna's rounding, done in two
// integer operations) and small = a - big, exact in fp32 (the tensor cores
// read its top 19 bits: at most 2^-21 |a| lost), and
// q.x = qs.xb + qb.xs + qb.xb, small terms first.  The tensor cores' fp32
// sums round toward zero, which over D = 784 drifts by ~1e-5 of |q||x|, so
// each 32-deep stage is summed alone (12 wgmma into a fresh accumulator)
// and added to the running sum with a rounded fp32 add.  That keeps ~21 of
// fp32's 24 bits, inside the port's tolerance (rtol 2e-4 + 1e-5 |q||x|);
// plain TF32 (~11 bits) would reorder near neighbours.  ||q||^2 and
// ||x||^2 are summed in fp32 FMAs from the same shared tiles while they
// are split, so the corpus is read once.
//
// What bounds it on an H100.  The matrix entry at the flat route's shape
// (Q = 1,024 x one 65,536-row chunk, D = 128) does 3 x 1.72e10 tensor-core
// flops: 0.104 ms at 495 TFLOP/s TF32; its bytes (inputs once, the 268 MB
// output) take 0.090 ms at 3.35 TB/s.  The fused entry has no (Q, N)
// write: at Q = 1,024 x 1M x 128 its 0.5 GB of corpus takes 0.15 ms and its
// 3 x 2.7e11 flops 1.63 ms, so it is bound by operations; the batcher's
// Q <= 32 are bound by the corpus read.  In practice shared memory holds
// it back: every stage is read by the split and three times by the
// tensor cores (PERF.md).
//
// Design.  A block is three warpgroups: two consumers, each owning 64 rows
// of the A side, and one producer.  A block owns one q tile and a
// contiguous range of 128-row corpus tiles (about one block per SM:
// splits = SMs / q tiles).  D is walked in 32-float chunks (128 bytes, the
// swizzle width) through a ring of shared stages; each stage holds an A
// chunk and a B chunk, and beside each its `small` half:
//   Q > 32:  A = 128 query rows, B = 128 corpus rows, wgmma m64n128k8;
//            3 stages x 64 KB = 192 KB.
//   Q <= 32: roles swapped (the batcher's buckets would waste most of
//            wgmma's 64-row M): A = 128 corpus rows, B = the <= 32 queries
//            (zero rows past Q), wgmma m64n32k8; 4 stages x 40 KB = 160 KB.
// Beside the ring: 3 tiles' norms (3 KB), and for the fused entry the rows'
// k-th keys (1 KB), the top-k lists in shared memory while 128 rows x k
// keys fit in 16 KB (k <= 16 for Q > 32, k <= 64 for Q <= 32; in cand
// itself past that, slower), and a 2 KB buffer (Q > 32) or a 32 x 129
// staging tile (Q <= 32): at most 214 KB of the 227 KB a block may use.
// The queries are streamed with the corpus, not kept resident: at D = 784
// a 128-row query tile (big + small) is 800 KB, and at D = 128 its 128 KB
// would leave room for two corpus stages only; the 0.5 MB of queries stay
// in L2.
// Loads: TMA with 128-byte swizzle when D % 4 == 0 and both bases are
// 16-byte aligned (TMA's stride and address rules), zero-filling rows past
// the end and the D tail; other shapes (D = 130, 7, 1, a row view one float
// off alignment) take plain loads by the producer warpgroup into the same
// swizzled layout.  The choice is by shape, made on the host.
// The consumers issue a stage's 12 wgmma, split the next arrived stage in
// place (big over the raw value, small beside it), fence the async proxy
// and meet at a named barrier; then they add the stage's products and
// release its buffers to the producer.  At a tile's last stage the
// epilogue runs: finish() per element (an explicit fma and adds, so both
// entries round alike); the matrix entry stores it; the fused entry
// filters each distance against its row's current k-th distance (ties are
// settled by the key on insertion), and the lanes with survivors, one at a
// time, park their 64 distances in the warp's buffer and insert the
// survivors into their rows' sorted lists, each row owned by one warp (for
// Q <= 32 through the staging tile, which all eight warps write and read,
// with a consumers' barrier before the writes and one after).  Survivors are few once the lists
// fill (about k (1 + ln(N / k)) a row over the scan).
//
// TMA descriptors come from cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (no -lcuda), encoded on the host per launch.
// The kernels allocate nothing, launch on the caller's stream and the entry
// points return cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 384;          // consumers 0-255, producer 256-383
constexpr int kTile = 128;             // A rows a block tile; corpus rows
constexpr int kChunk = 32;             // floats of D a stage (128 bytes)
constexpr int kSwapQ = 32;             // Q at or under which roles swap
constexpr int kListBytes = 16384;      // top-k lists kept in shared memory
constexpr int kStgPitch = kTile + 1;   // Q <= 32 staging tile row pitch
constexpr int kNormBufs = 3;           // tiles whose norms are live at once
constexpr long long kEmpty = 0x7FFFFFFFFFFFFFFFLL;   // above every key

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

__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  while (!mbar_try_wait(b, parity)) {
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// the two consumer warpgroups meet here (barrier 0 is __syncthreads')
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// cvt.rna.tf32.f32 in two integer operations: round the magnitude to 10
// mantissa bits, ties away from zero (a carry into the exponent is right)
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// wgmma operand descriptor: K-major, 128-byte swizzle, 8-row atoms of
// 1,024 bytes (stride byte offset 64 x 16); the leading byte offset is
// unused for swizzled K-major layouts.  A k-step of 8 tf32 (32 bytes)
// adds 2 to the start address.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(64) << 32) | (static_cast<uint64_t>(1) << 62);
}

// D (64 x N) (+)= A (64 x 8) . B (N x 8)^T: tf32 operands from shared memory,
// both K-major with 128-byte swizzle; fp32 accumulators in the fragment
// layout (thread t: row 16 (t / 32) + (t % 32) / 4 (+ 8), column
// 8 j + 2 (t % 4) (+ 1)); scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}


__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// pins the accumulators at this point of the instruction stream, so no
// read or write of them moves across a wgmma fence or wait
template <int N>
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the epilogue arithmetic of both entries, rounded explicitly: mode 0 l2,
// 1 dot, 2 cosine
template <int kMode>
__device__ __forceinline__ float finish(float c, float qq, float xx) {
  if constexpr (kMode == 0)
    return fmaxf(__fmaf_rn(-2.f, c, __fadd_rn(qq, xx)), 0.f);
  else if constexpr (kMode == 1)
    return -c;
  else
    return __fadd_rn(1.f, -c);
}

// float bits -> int32 in the same order: -0.0 below +0.0, NaN above +inf
__device__ __forceinline__ int ordered(float d) {
  const int b = __float_as_int(d);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

// core/flat.py's key: float bits in order (-0.0 below +0.0, NaN above
// +inf) in the high word, the column in the low word
__device__ __forceinline__ long long order_key(float d, int col) {
  return (static_cast<long long>(ordered(d)) << 32) |
         static_cast<long long>(static_cast<uint32_t>(col));
}

// insert key into a row's ascending list of k keys (shared or global),
// keeping *thr = its k-th key
__device__ __forceinline__ void insert_key(long long* list, long long* thr,
                                        int k, long long key) {
  if (key >= list[k - 1]) return;
  int p = k - 1;
  while (p > 0 && list[p - 1] > key) {
    list[p] = list[p - 1];
    --p;
  }
  list[p] = key;
  *thr = list[k - 1];
}

struct Args {
  const float* a;           // A side (Q > 32: queries; else corpus)
  const float* b;           // B side
  float* out;               // matrix entry
  const uint8_t* mask;      // fused entry, may be null
  long long* cand;          // fused entry: (Q, splits, k)
  int a_rows, b_rows, Q, N, D, mode, splits, k;
  int list_shared;          // fused: lists in shared memory
};

template <bool kSwap>
struct Shape {
  static constexpr int BN = kSwap ? 32 : 128;        // B rows a tile
  static constexpr int NACC = BN / 2;                // accumulators a thread
  static constexpr int STAGES = kSwap ? 4 : 3;
  static constexpr int A_BYTES = kTile * kChunk * 4; // 16 KB
  static constexpr int B_BYTES = BN * kChunk * 4;
  static constexpr int STAGE_BYTES = 2 * (A_BYTES + B_BYTES);
  static constexpr int LROWS = kSwap ? kSwapQ : kTile;  // query rows a block
};

// dynamic shared memory layout (after aligning the base to 1,024 bytes):
// ring, full[STAGES], empty[STAGES], norms A [3][128], norms B [3][BN],
// thr [LROWS], lists, staging
template <bool kSwap, bool kFused>
struct Layout {
  using S = Shape<kSwap>;
  static constexpr int RING = S::STAGES * S::STAGE_BYTES;
  static constexpr int BARS = RING;
  static constexpr int NA = BARS + 2 * S::STAGES * 8;
  static constexpr int NB = NA + kNormBufs * kTile * 4;
  static constexpr int THR = NB + kNormBufs * S::BN * 4;
  static constexpr int LISTS = THR + S::LROWS * 8;
  static constexpr int STG = LISTS + (kFused ? kListBytes : 0);
  // fused: for Q <= 32 the staged tile, else a warp's 64 distances
  static constexpr int END =
      STG + (kFused ? (kSwap ? kSwapQ * kStgPitch * 4 : 8 * 64 * 4) : 0);
  static constexpr int BYTES = END + 1024;           // alignment slack
};

// the main loop and both epilogues; tm_a and tm_b are the kernel's
// __grid_constant__ parameters (TMA reads the descriptors where they lie)
template <bool kSwap, bool kTma, bool kFused, int kMode>
__device__ __forceinline__ void l2_body(const CUtensorMap& tm_a,
                                        const CUtensorMap& tm_b,
                                        const Args& p) {
  using S = Shape<kSwap>;
  using L = Layout<kSwap, kFused>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + S::STAGES;
  float* norm_a = reinterpret_cast<float*>(smem + L::NA);
  float* norm_b = reinterpret_cast<float*>(smem + L::NB);
  long long* thr = reinterpret_cast<long long*>(smem + L::THR);
  long long* lists_s = reinterpret_cast<long long*>(smem + L::LISTS);
  float* stg = reinterpret_cast<float*>(smem + L::STG);
  auto a_buf = [&](int s) { return smem + s * S::STAGE_BYTES; };
  auto a_small = [&](int s) { return a_buf(s) + S::A_BYTES; };
  auto b_buf = [&](int s) { return a_buf(s) + 2 * S::A_BYTES; };
  auto b_small = [&](int s) { return b_buf(s) + S::B_BYTES; };

  const int tid = threadIdx.x;
  const int q_tile = blockIdx.x / p.splits;
  const int split = blockIdx.x % p.splits;
  const int n_tiles = (p.N + kTile - 1) / kTile;
  const int t_begin = static_cast<int>(
      static_cast<long long>(split) * n_tiles / p.splits);
  const int t_end = static_cast<int>(
      static_cast<long long>(split + 1) * n_tiles / p.splits);
  const int n_chunks = (p.D + kChunk - 1) / kChunk;
  const int q0 = kSwap ? 0 : q_tile * kTile;

  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], kTma ? 1 : 128);
      mbar_init(&empty[s], 8);                 // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int pt = tid - 256;
    if (kTma && pt != 0) return;
    int stage = 0, phase = 0;
    for (int t = t_begin; t < t_end; ++t) {
      const int a_row0 = kSwap ? t * kTile : q0;
      const int b_row0 = kSwap ? 0 : t * kTile;
      for (int kc = 0; kc < n_chunks; ++kc) {
        mbar_wait(&empty[stage], phase ^ 1);
        if constexpr (kTma) {
          mbar_expect_tx(&full[stage], S::A_BYTES + S::B_BYTES);
          tma_load(a_buf(stage), &tm_a, kc * kChunk, a_row0, &full[stage]);
          tma_load(b_buf(stage), &tm_b, kc * kChunk, b_row0, &full[stage]);
        } else {
          // plain loads into the swizzled layout: row r's 16-byte group g
          // sits at r * 128 + ((g ^ (r % 8)) * 16)
          const int k0 = kc * kChunk;
          for (int i = pt; i < kTile * kChunk; i += 128) {
            const int r = i / kChunk, c = i % kChunk;
            const int gr = a_row0 + r, gk = k0 + c;
            const float v = (gr < p.a_rows && gk < p.D)
                                ? p.a[static_cast<size_t>(gr) * p.D + gk]
                                : 0.f;
            *reinterpret_cast<float*>(a_buf(stage) + r * 128 +
                                      (((c >> 2) ^ (r & 7)) << 4) +
                                      (c & 3) * 4) = v;
          }
          for (int i = pt; i < S::BN * kChunk; i += 128) {
            const int r = i / kChunk, c = i % kChunk;
            const int gr = b_row0 + r, gk = k0 + c;
            const float v = (gr < p.b_rows && gk < p.D)
                                ? p.b[static_cast<size_t>(gr) * p.D + gk]
                                : 0.f;
            *reinterpret_cast<float*>(b_buf(stage) + r * 128 +
                                      (((c >> 2) ^ (r & 7)) << 4) +
                                      (c & 3) * 4) = v;
          }
          mbar_arrive(&full[stage]);
        }
        if (++stage == S::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = tid / 128, t128 = tid % 128;
  const int warp = t128 / 32, lane = tid % 32;
  constexpr bool l2 = kMode == 0;
  // this thread's share of the split: A row 64 wg + t128 / 2, half a row;
  // B row (BN / 2) wg + t128 / TPR_B, CPT_B of its 8 16-byte groups
  constexpr int CPT_B = S::BN / 32;
  constexpr int TPR_B = 8 / CPT_B;
  const int a_row = 64 * wg + t128 / 2;
  const int b_row = (S::BN / 2) * wg + t128 / TPR_B;

  long long* my_lists = nullptr;   // list of local query row r: + r * k
  if constexpr (kFused) {
    const int rows = min(S::LROWS, p.Q - q0);
    if (p.list_shared) {
      my_lists = lists_s;
      for (int i = tid; i < rows * p.k; i += 256) lists_s[i] = kEmpty;
    } else {
      for (int r = tid; r < rows; r += 256) {
        long long* row = p.cand +
            (static_cast<size_t>(q0 + r) * p.splits + split) * p.k;
        for (int j = 0; j < p.k; ++j) row[j] = kEmpty;
      }
    }
    for (int r = tid; r < S::LROWS; r += 256) thr[r] = kEmpty;
  }
  auto list_of = [&](int r) -> long long* {
    return p.list_shared
               ? my_lists + static_cast<size_t>(r) * p.k
               : p.cand + (static_cast<size_t>(q0 + r) * p.splits + split) *
                              p.k;
  };

  // split one arrived stage in place (big over the raw value, small
  // beside it), adding this thread's squares to na / nbv in l2 mode.  All
  // of the thread's groups are read before any is written: the stores
  // could alias the loads, so this order keeps the loads in flight together
  float na = 0.f, nbv = 0.f;
  auto split_group = [&](float4* raw, float4* sml, int g, float4 v,
                         float& part) {
    if (l2) {
      part = fmaf(v.x, v.x, part);
      part = fmaf(v.y, v.y, part);
      part = fmaf(v.z, v.z, part);
      part = fmaf(v.w, v.w, part);
    }
    // small is left as the exact fp32 difference: the tensor cores read
    // its top 19 bits, an error of at most 2^-21 |a|
    float4 bg, sm;
    bg.x = tf32_rna(v.x); sm.x = __fsub_rn(v.x, bg.x);
    bg.y = tf32_rna(v.y); sm.y = __fsub_rn(v.y, bg.y);
    bg.z = tf32_rna(v.z); sm.z = __fsub_rn(v.z, bg.z);
    bg.w = tf32_rna(v.w); sm.w = __fsub_rn(v.w, bg.w);
    raw[g] = bg;
    sml[g] = sm;
  };
  auto split_stage = [&](int s) {
    float4* raw_a = reinterpret_cast<float4*>(a_buf(s) + a_row * 128);
    float4* sml_a = reinterpret_cast<float4*>(a_small(s) + a_row * 128);
    float4* raw_b = reinterpret_cast<float4*>(b_buf(s) + b_row * 128);
    float4* sml_b = reinterpret_cast<float4*>(b_small(s) + b_row * 128);
    float4 va[4], vb[CPT_B];
    int ga[4], gb[CPT_B];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ga[j] = ((t128 & 1) * 4 + j) ^ (a_row & 7);
      va[j] = raw_a[ga[j]];
    }
#pragma unroll
    for (int j = 0; j < CPT_B; ++j) {
      gb[j] = ((t128 % TPR_B) * CPT_B + j) ^ (b_row & 7);
      vb[j] = raw_b[gb[j]];
    }
    float pa = 0.f, pb = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) split_group(raw_a, sml_a, ga[j], va[j], pa);
#pragma unroll
    for (int j = 0; j < CPT_B; ++j)
      split_group(raw_b, sml_b, gb[j], vb[j], pb);
    if (l2) {
      na = __fadd_rn(na, __fadd_rn(pa, __shfl_xor_sync(~0u, pa, 1)));
#pragma unroll
      for (int o = 1; o < TPR_B; o <<= 1)
        pb = __fadd_rn(pb, __shfl_xor_sync(~0u, pb, o));
      nbv = __fadd_rn(nbv, pb);
    }
  };

  // the stage's 12 products into part (the first one overwrites it): the
  // tensor cores' fp32 sums round toward zero, so each 32-deep stage is
  // summed alone and added to acc with a rounded fp32 add
  float acc[S::NACC], part[S::NACC];
#pragma unroll
  for (int i = 0; i < S::NACC; ++i) acc[i] = 0.f;
  auto issue = [&](int s) {
    const uint64_t da = smem_desc(a_buf(s) + wg * 64 * 128);
    const uint64_t ds = smem_desc(a_small(s) + wg * 64 * 128);
    const uint64_t db = smem_desc(b_buf(s));
    const uint64_t dbs = smem_desc(b_small(s));
    pin<S::NACC>(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 8; ++kk) {
      if constexpr (kSwap) {
        wgmma_n32(part, ds + 2 * kk, db + 2 * kk, kk > 0);
        wgmma_n32(part, da + 2 * kk, dbs + 2 * kk, 1);
        wgmma_n32(part, da + 2 * kk, db + 2 * kk, 1);
      } else {
        wgmma_n128(part, ds + 2 * kk, db + 2 * kk, kk > 0);
        wgmma_n128(part, da + 2 * kk, dbs + 2 * kk, 1);
        wgmma_n128(part, da + 2 * kk, db + 2 * kk, 1);
      }
    }
    wgmma_commit();
  };

  // the epilogue of tile t from acc: accumulator i of this thread is A row
  // 64 wg + 16 warp + lane / 4 (+ 8 for i % 4 >= 2), B row 8 (i / 4) +
  // 2 (lane % 4) + i % 2
  auto epilogue = [&](int t) {
    const int n0 = t * kTile;
    const int nb = (t - t_begin) % kNormBufs;
    const float* na_s = norm_a + nb * kTile;
    const float* nb_s = norm_b + nb * S::BN;
    // accumulator i: A row ar(i), B row bc(i); local query row and column
    auto ar = [&](int i) {
      return 64 * wg + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
    };
    auto bc = [&](int i) { return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1); };
    auto qrow = [&](int i) { return kSwap ? bc(i) : ar(i); };
    auto col = [&](int i) { return n0 + (kSwap ? ar(i) : bc(i)); };
    auto value = [&](int i) -> float {
      float qq = 0.f, xx = 0.f;
      if (l2) {
        qq = kSwap ? nb_s[bc(i)] : na_s[ar(i)];
        xx = kSwap ? na_s[ar(i)] : nb_s[bc(i)];
      }
      return finish<kMode>(acc[i], qq, xx);
    };
    if constexpr (!kFused) {
      const bool pairs = !kSwap && (p.N & 1) == 0;
#pragma unroll
      for (int i = 0; i < S::NACC; i += 2) {
        const float v0 = value(i), v1 = value(i + 1);
        const int r = qrow(i), c = col(i);
        if (q0 + r >= p.Q) continue;
        float* o = p.out + static_cast<size_t>(q0 + r) * p.N;
        if (pairs && c + 1 < p.N) {
          *reinterpret_cast<float2*>(o + c) = make_float2(v0, v1);
        } else if (!kSwap) {
          if (c < p.N) o[c] = v0;
          if (c + 1 < p.N) o[c + 1] = v1;
        } else if (c < p.N) {
          o[c] = v0;                          // rows r and r + 1, column c
          if (q0 + r + 1 < p.Q) o[p.N + c] = v1;
        }
      }
    } else if constexpr (!kSwap) {
      // this warp owns its 16 query rows; each lane holds two of them (row
      // r0 for i % 4 < 2, r0 + 8 else) at 32 columns c0 + 8 j + e, live
      // bit 2 j + e (mask, and columns past N).  Filter on the rows' k-th
      // distances; then the lanes with survivors, one at a time, park their
      // 64 distances in the warp's buffer and insert from it
      const int r0 = 64 * wg + 16 * warp + (lane >> 2);
      const int c0 = n0 + 2 * (lane & 3);
      uint32_t live = ~0u;
      if (p.mask != nullptr || n0 + kTile > p.N) {
        live = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = c0 + 8 * j + e;
            if (c < p.N && (p.mask == nullptr || p.mask[c]))
              live |= 1u << (2 * j + e);
          }
      }
      // the rows' k-th keys as floats: a value can enter a list only if
      // its distance is <= the list's k-th (ties go to the column, settled
      // on insertion); the k-th of a list not yet full is kEmpty's NaN and
      // lets every value in; a row past Q takes none
      auto kth = [&](int r, bool& all) -> float {
        const int o = static_cast<int>(thr[r] >> 32);
        const float f = __int_as_float(o >= 0 ? o : o ^ 0x7FFFFFFF);
        const bool row_ok = q0 + r < p.Q;
        all = row_ok && f != f;
        return row_ok ? f : __int_as_float(0x7FFFFFFF);
      };
      bool all0, all1;
      const float tf0 = kth(r0, all0), tf1 = kth(r0 + 8, all1);
      // masked columns score +inf
      auto dist = [&](int i) -> float {
        const int bit = 2 * (i >> 2) + (i & 1);
        return (live >> bit) & 1 || p.mask == nullptr
                   ? value(i) : __int_as_float(0x7F800000);
      };
      unsigned long long surv = 0;
#pragma unroll
      for (int i = 0; i < S::NACC; ++i) {
        const bool hi = (i >> 1) & 1;
        if (dist(i) <= (hi ? tf1 : tf0) || (hi ? all1 : all0))
          surv |= 1ull << i;
      }
      if (n0 + kTile > p.N) {               // the corpus's last tile
#pragma unroll
        for (int i = 0; i < S::NACC; ++i)
          if (c0 + 8 * (i >> 2) + (i & 1) >= p.N) surv &= ~(1ull << i);
      }
      unsigned pend = __ballot_sync(~0u, surv != 0);
      float* buf = stg + (wg * 4 + warp) * 64;
      while (pend) {
        const int src = __ffs(pend) - 1;
        if (lane == src) {
#pragma unroll
          for (int i = 0; i < S::NACC; i += 4)
            *reinterpret_cast<float4*>(buf + i) =
                make_float4(dist(i), dist(i + 1), dist(i + 2), dist(i + 3));
          while (surv) {
            const int i = __ffsll(static_cast<long long>(surv)) - 1;
            surv &= surv - 1;
            const int r = r0 + 8 * ((i >> 1) & 1);
            const long long key =
                order_key(buf[i], c0 + 8 * (i >> 2) + (i & 1));
            if (key < thr[r]) insert_key(list_of(r), &thr[r], p.k, key);
          }
        }
        __syncwarp();
        pend &= pend - 1;
      }
    } else {
      // Q <= 32: a query's 128 values lie across all eight warps; stage
      // the tile (masked rows at +inf), then warp w selects for queries
      // 4 w .. 4 w + 3.  Warps of the other warpgroup may still be reading
      // the previous tile from the staging tile (the loop's last stage has
      // no prepare() and so no barrier before this epilogue): meet first
      consumers_sync();
#pragma unroll
      for (int i = 0; i < S::NACC; ++i) {
        const int c = col(i);
        const bool live = p.mask == nullptr || (c < p.N && p.mask[c]);
        stg[qrow(i) * kStgPitch + (c - n0)] =
            live ? value(i) : __int_as_float(0x7F800000);
      }
      consumers_sync();
      const int gw = wg * 4 + warp;
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * gw + j;
        if (r >= p.Q) break;
        const int th = static_cast<int>(thr[r] >> 32);
        unsigned surv = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cc = n0 + lane + 32 * c;
          if (cc < p.N && ordered(stg[r * kStgPitch + lane + 32 * c]) <= th)
            surv |= 1u << c;
        }
        unsigned pend = __ballot_sync(~0u, surv != 0);
        while (pend) {
          const int src = __ffs(pend) - 1;
          if (lane == src) {
            while (surv) {
              const int c = __ffs(surv) - 1;
              surv &= surv - 1;
              insert_key(list_of(r), &thr[r], p.k,
                         order_key(stg[r * kStgPitch + lane + 32 * c],
                                   n0 + lane + 32 * c));
            }
          }
          __syncwarp();
          pend &= pend - 1;
        }
      }
    }
  };

  // software pipeline over the block's (tile, chunk) sequence, one stage
  // in flight: issue stage it; while the tensor cores run it, split stage
  // it + 1; then add stage it's products into acc, release its buffers
  // and, at a tile's last chunk, finish the tile
  auto prepare = [&](int it, int s, int ph) {
    const int t = t_begin + it / n_chunks, kc = it % n_chunks;
    mbar_wait(&full[s], ph);
    if (kc == 0) na = nbv = 0.f;
    split_stage(s);
    if (l2 && kc == n_chunks - 1) {
      const int nb = (t - t_begin) % kNormBufs;
      if ((t128 & 1) == 0) norm_a[nb * kTile + a_row] = na;
      if (t128 % TPR_B == 0) norm_b[nb * S::BN + b_row] = nbv;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumers_sync();
  };
  const int total = (t_end - t_begin) * n_chunks;
  int stage = 0, phase = 0;
  prepare(0, 0, 0);
  for (int it = 0; it < total; ++it) {
    const int t = t_begin + it / n_chunks, kc = it % n_chunks;
    issue(stage);
    const int next = stage + 1 == S::STAGES ? 0 : stage + 1;
    const int next_phase = next == 0 ? phase ^ 1 : phase;
    if (it + 1 < total) prepare(it + 1, next, next_phase);
    wgmma_wait_all();
    pin<S::NACC>(part);
#pragma unroll
    for (int i = 0; i < S::NACC; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (kc == n_chunks - 1) {
      epilogue(t);
#pragma unroll
      for (int i = 0; i < S::NACC; ++i) acc[i] = 0.f;
    }
    stage = next;
    phase = next_phase;
  }

  if constexpr (kFused) {
    if (p.list_shared) {
      consumers_sync();
      const int rows = min(S::LROWS, p.Q - q0);
      for (int i = tid; i < rows * p.k; i += 256) {
        const int r = i / p.k, j = i % p.k;
        p.cand[(static_cast<size_t>(q0 + r) * p.splits + split) * p.k + j] =
            lists_s[i];
      }
    }
  }
}

// the matrix entry's kernel and the fused entry's, named apart for the
// profiler
template <bool kSwap, bool kTma, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    l2_distance_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b,
                       const Args p) {
  l2_body<kSwap, kTma, false, kMode>(tm_a, tm_b, p);
}

template <bool kSwap, bool kTma, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    l2_topk_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b, const Args p) {
  l2_body<kSwap, kTma, true, kMode>(tm_a, tm_b, p);
}


inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// cuTensorMapEncodeTiled, a driver API function, through the runtime's
// entry-point query: the library then needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// rows x D row-major fp32, read in boxes of box_rows x 32 floats with
// 128-byte swizzle; rows and the D tail past the end read as zeros
bool make_map(CUtensorMap* m, const float* base, int rows, int D,
              int box_rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kChunk),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kSwap, bool kTma, bool kFused, int kMode>
int launch(const Args& a, int grid, cudaStream_t s) {
  using S = Shape<kSwap>;
  constexpr int bytes = Layout<kSwap, kFused>::BYTES;
  CUtensorMap ta, tb;
  memset(&ta, 0, sizeof(ta));
  memset(&tb, 0, sizeof(tb));
  if (kTma && !(make_map(&ta, a.a, a.a_rows, a.D, kTile) &&
                make_map(&tb, a.b, a.b_rows, a.D, S::BN)))
    return static_cast<int>(cudaErrorNotSupported);
  auto kernel = kFused ? l2_topk_kernel<kSwap, kTma, kMode>
                      : l2_distance_kernel<kSwap, kTma, kMode>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, bytes, s>>>(ta, tb, a);
  return static_cast<int>(cudaGetLastError());
}

// the mode is compiled in: each kernel carries one epilogue
template <bool kSwap, bool kTma, bool kFused>
int by_mode(const Args& a, int grid, cudaStream_t s) {
  if (a.mode == 0) return launch<kSwap, kTma, kFused, 0>(a, grid, s);
  if (a.mode == 1) return launch<kSwap, kTma, kFused, 1>(a, grid, s);
  if constexpr (kFused) return launch<kSwap, kTma, kFused, 2>(a, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kSwap, bool kFused>
int by_loads(const Args& a, bool tma, int grid, cudaStream_t s) {
  return tma ? by_mode<kSwap, true, kFused>(a, grid, s)
             : by_mode<kSwap, false, kFused>(a, grid, s);
}

// the shape picks the variant: roles swap at Q <= 32; TMA loads when
// D % 4 == 0 and both bases are 16-byte aligned, plain loads otherwise
template <bool kFused>
int run(Args a, const float* q, const float* x, int Q, int N, int D,
        cudaStream_t s) {
  const bool swap = Q <= kSwapQ;
  const bool tma = D % 4 == 0 && aligned16(q) && aligned16(x);
  a.a = swap ? x : q;
  a.b = swap ? q : x;
  a.a_rows = swap ? N : Q;
  a.b_rows = swap ? Q : N;
  a.Q = Q;
  a.N = N;
  a.D = D;
  const long long q_tiles = swap ? 1 : (Q + kTile - 1) / kTile;
  const long long n_tiles = (N + kTile - 1) / kTile;
  if (a.splits < 1 || a.splits > n_tiles || q_tiles * a.splits > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(q_tiles * a.splits);
  a.list_shared = (swap ? kSwapQ : kTile) * a.k * 8 <= kListBytes;
  return swap ? by_loads<true, kFused>(a, tma, grid, s)
              : by_loads<false, kFused>(a, tma, grid, s);
}

}  // namespace

// the matrix entry: out (Q, N) f32, mode 0 = l2, 1 = dot
extern "C" int l2_distance_f32(const float* q, const float* x, float* out,
                               int Q, int N, int D, int mode, int splits,
                               void* stream) {
  if (Q <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (D <= 0 || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.out = out;
  a.mode = mode;
  a.splits = splits;
  return run<false>(a, q, x, Q, N, D, static_cast<cudaStream_t>(stream));
}

// the largest k whose top-k lists the fused entry keeps in shared memory
// at Q queries (past it they live in cand, slower); core/flat.py's
// fused_fast_k, which dispatches without the library, must agree
extern "C" int l2_topk_fast_k(int Q) {
  return kListBytes / ((Q <= kSwapQ ? kSwapQ : kTile) * 8);
}

// the fused entry: cand (Q, splits, k) int64, each (query, split) row the
// ascending k smallest keys of the split's corpus rows (mask == 0 rows as
// +inf; mask may be null); mode 0 = l2, 1 = dot, 2 = cosine
extern "C" int l2_topk_f32(const float* q, const float* x,
                           const uint8_t* mask, long long* cand, int Q, int N,
                           int D, int mode, int k, int splits, void* stream) {
  if (Q <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0 || D <= 0 || mode < 0 || mode > 2 || k < 1 || k > 256 ||
      k > N)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.mask = mask;
  a.cand = cand;
  a.mode = mode;
  a.splits = splits;
  a.k = k;
  return run<true>(a, q, x, Q, N, D, static_cast<cudaStream_t>(stream));
}
