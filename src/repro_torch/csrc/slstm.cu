// sLSTM recurrence over a whole sequence: the stabilised exp-gate cell with
// block-diagonal per-head recurrent weights.
//
// Replaces: src/repro/kernels/slstm.py, slstm_sequence_kernel (Pallas body
// _slstm_kernel):
//   gates (B, S, 4d) bf16 | f32 x r (4, H, blk, blk) f32 x b (4d,) f32
//   -> h (B, S, d) in the gates' dtype.  For t = 0..S-1:
//     pre  = gates[:, t] + h.R (pre[g*d + n*blk + l] += sum_k h[n*blk + k]
//            * R[g, n, k, l]) + b
//     logf = log_sigmoid(pre_f);  m' = max(logf + m, pre_i)
//     i'   = exp(pre_i - m');     f' = exp(logf + m - m')
//     c'   = f' c + i' tanh(pre_z);  n' = f' n + i'
//     h'   = sigmoid(pre_o) c' / max(n', 1e-6)
//   from h = c = n = 0, m = -1e30, the state in f32.
//
// What bounds it on an H100: operations.  The recurrent product is
// 2 * B * S * 4d * blk flops (137 GFLOP at B = 8, S = 2,048, d = 2,048,
// blk = 512: 2.05 ms at 67 TFLOP/s fp32) against 0.35 GB of gates, output
// and R (0.105 ms at 3.35 TB/s).  The S steps are sequential, and every step
// needs the whole h of its head from the step before: a latency floor of S
// exchanges that the bound does not count.
//
// Design: the TPU kernel keeps R resident in VMEM for the whole sequence
// and carries (h, c, n, m) across sequential grid steps.  Here R is
// block-diagonal, so head n's h_t needs only head n's h_{t-1}, and batch rows
// never meet: each (head, group of RB batch rows) is one thread block
// cluster of CS = blk / 32 blocks (16 at blk = 512, the non-portable
// maximum), and nothing crosses clusters.  Two paths:
//
// * cluster (blk a multiple of 32, at most 512): block c of a cluster owns
//   units l0 = 32c .. l0 + 31 of its head and keeps their columns of R,
//   R[g, n, :, l0:l0+32] (4 x blk x 32 floats, 256 KB at blk = 512), on
//   chip for the whole sequence: each lane takes 4 gates x 2 units over one
//   of 16 k-slices (8 warps x 2 half-warps) and holds the slice's first
//   KR = 16 k of R in registers (128 a thread), the rest in shared memory
//   (128 KB); at blk = 512 the two parts run in step, so that the shared
//   part's loads overlap the register part's products.  h_{t-1}[rows, k]
//   comes from the block's own shared memory; each h value read feeds 8
//   products.  The 16 slices' partial sums meet in shared memory in a fixed
//   order, and one thread per (row, unit) runs the cell with c, n, m in
//   registers for the whole sequence, writes h to the output (rounded to
//   nearest, __float2bfloat16_rn, as Tensor.to(torch.bfloat16)) and stages
//   it.  The block then writes its 32 x RB / 2 h values into every peer's h
//   buffer with asynchronous remote stores (st.async into distributed
//   shared memory), double-buffered by step parity; each store completes on
//   the peer's mbarrier, whose transaction count says when all CS slices
//   have landed.  The RB rows run as two halves a half-step apart, so that
//   one half's h travels while the other half computes.  No barrier spans
//   the cluster inside the loop, no grid barrier, no h from global memory.
//   A cell's gates are loaded a step ahead (they do not depend on h).  The
//   launch is an ordinary cluster launch: clusters need not be co-resident.
//   RB is 8 or 4 (R copied per cluster), whichever gives the fewer waves of
//   clusters times rows, by cudaOccupancyMaxActiveClusters (7 clusters of 16
//   on an H100 SXM: 4 of 8 rows at B = 8, 4 heads; 4 of 4 rows at B = 1).
// * l2 (every other width: blk not a multiple of 32 or over 512): one
//   persistent cooperative launch walks the whole sequence, its blocks
//   spread over the SMs.  A block owns tiles of 16 units l of one head n;
//   with one tile per block it copies its R columns R[g, n, :, l0:l0+16]
//   (4 x blk x 16 floats) into shared memory once, and when the tiles
//   outnumber the blocks that fit on the card at once, or the columns do not
//   fit, it reads them from L2.  At each step, for each tile and 8 batch
//   rows at a time, the block stages h_{t-1}[rows, n, :] from L2 in shared
//   memory and its 256 threads split the blk-deep product 16 ways (thread =
//   16 k-slices x 16 units), each holding 4 gates x 8 rows of fp32 sums;
//   the two k-slices of a warp are added with a shuffle, the warps' partial
//   sums through shared memory in a fixed order, and one thread per (row,
//   unit) runs the cell, keeping c, n, m in f32 global state that only it
//   touches and writing h to a ping-pong f32 buffer and to the output.  A
//   grid-wide barrier (cooperative groups, which fences memory) then makes
//   h_t visible to every block before step t + 1.
//
// Both paths start step 0 from the constant state and skip its product, and
// use no fast-math intrinsics: expf, log1pf, tanhf.  The save entries
// (training) run the same launches with one more store of each step's
// pre-activations, c, n, m and h in the cell: nothing else changes, so h
// keeps the serving entries' bits.  The kernel allocates
// nothing (the wrapper passes the 5 x B x d f32 scratch the l2 path uses),
// launches on the caller's stream and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "slstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace slstm_dev;

constexpr int kThreads = 256;
constexpr int kTL = 16;                 // units per tile
constexpr int kKS = kThreads / kTL;     // k-slices per block
constexpr int kWarps = kThreads / 32;
constexpr int kBB = 8;                  // batch rows per pass
constexpr int kRedFloats = kWarps * 4 * kBB * kTL;

// what the backward (csrc/slstm_backward.cu) reads of step t: save is (8,
// B, S, d) f32, fields pre_i, pre_f, pre_z, pre_o, c, n, m, h; `at` is
// (row * S + t) * d + unit, `bsd` = B * S * d
__device__ __forceinline__ void save_step(float* save, const float* pre,
                                          float c, float n, float m, float h,
                                          size_t at, size_t bsd) {
#pragma unroll
  for (int g = 0; g < 4; ++g) save[g * bsd + at] = pre[g];
  save[4 * bsd + at] = c;
  save[5 * bsd + at] = n;
  save[6 * bsd + at] = m;
  save[7 * bsd + at] = h;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
slstm_sequence_kernel(const T* __restrict__ gates,
                      const float* __restrict__ r,
                      const float* __restrict__ bias,
                      float* __restrict__ h_buf, float* __restrict__ c_st,
                      float* __restrict__ n_st, float* __restrict__ m_st,
                      T* __restrict__ out, int B, int S, int d, int H,
                      int blk, int r_in_smem, float* __restrict__ save) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  float* red = smem;                    // [warp][gate][row][unit]
  float* h_s = smem + kRedFloats;       // [row][k]
  float* r_s = h_s + kBB * blk;         // [gate][k][unit], one tile

  const int tiles_per_head = (blk + kTL - 1) / kTL;
  const int n_tiles = H * tiles_per_head;
  const int tid = threadIdx.x;
  const int u = tid % kTL, ks = tid / kTL;
  const int lane = tid % 32, warp = tid / 32;
  const size_t bd = static_cast<size_t>(B) * d;
  const size_t gate_stride = static_cast<size_t>(H) * blk * blk;

  if (r_in_smem) {                      // one tile per block: blockIdx.x
    const int n = blockIdx.x / tiles_per_head;
    const int l0 = (blockIdx.x % tiles_per_head) * kTL;
    for (int i = tid; i < 4 * blk * kTL; i += kThreads) {
      const int g = i / (blk * kTL), k = (i / kTL) % blk, uu = i % kTL;
      r_s[i] = l0 + uu < blk
                   ? r[g * gate_stride + (static_cast<size_t>(n) * blk + k)
                       * blk + l0 + uu]
                   : 0.f;
    }
    __syncthreads();
  }

  for (int t = 0; t < S; ++t) {
    const float* h_prev = h_buf + (t % 2) * bd;
    float* h_next = h_buf + ((t + 1) % 2) * bd;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int n = tile / tiles_per_head;
      const int l0 = (tile % tiles_per_head) * kTL;
      const int l = l0 + u;
      for (int b0 = 0; b0 < B; b0 += kBB) {
        // the cell's own inputs first (they do not wait for h_{t-1}): one
        // thread per (row, unit) of this pass
        const int cb = tid / kTL, cu = tid % kTL;
        const int row = b0 + cb, lu = l0 + cu;
        const bool cell = tid < kBB * kTL && row < B && lu < blk;
        const int j = n * blk + lu;
        const size_t s_idx = static_cast<size_t>(row) * d + j;
        float gx[4] = {0.f, 0.f, 0.f, 0.f}, bv[4] = {0.f, 0.f, 0.f, 0.f};
        float c = 0.f, nn = 0.f, m = -1e30f;
        if (cell) {
          const size_t gate_base = (static_cast<size_t>(row) * S + t) * 4 * d;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            gx[g] = to_f32(gates[gate_base + static_cast<size_t>(g) * d + j]);
            bv[g] = bias[g * d + j];
          }
          if (t > 0) {
            c = c_st[s_idx];
            nn = n_st[s_idx];
            m = m_st[s_idx];
          }
        }

        float acc[4][kBB];
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int bb = 0; bb < kBB; ++bb) acc[g][bb] = 0.f;

        if (t > 0) {
#pragma unroll
          for (int bb = 0; bb < kBB; ++bb) {
            const float* src = h_prev + static_cast<size_t>(b0 + bb) * d
                               + n * blk;
            const bool valid = b0 + bb < B;
            for (int k = tid; k < blk; k += kThreads)
              h_s[bb * blk + k] = valid ? src[k] : 0.f;
          }
          __syncthreads();
          if (l < blk) {
            // column (g, k) of this unit: r_s[(g * blk + k) * kTL + u] or
            // R[g, n, k, l] in global memory
            const float* rc = r_in_smem
                ? r_s + u
                : r + static_cast<size_t>(n) * blk * blk + l;
            const size_t g_step = r_in_smem
                ? static_cast<size_t>(blk) * kTL : gate_stride;
            const int k_step = r_in_smem ? kTL : blk;
#pragma unroll 4
            for (int k = ks; k < blk; k += kKS) {
              float rv[4];
#pragma unroll
              for (int g = 0; g < 4; ++g)
                rv[g] = rc[g * g_step + static_cast<size_t>(k) * k_step];
#pragma unroll
              for (int bb = 0; bb < kBB; ++bb) {
                const float hv = h_s[bb * blk + k];
#pragma unroll
                for (int g = 0; g < 4; ++g)
                  acc[g][bb] = fmaf(hv, rv[g], acc[g][bb]);
              }
            }
          }
        }

        // the warp's two k-slices (lanes u and u + 16), then the warps in
        // order
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int bb = 0; bb < kBB; ++bb)
            acc[g][bb] += __shfl_down_sync(0xffffffffu, acc[g][bb], 16);
        if (lane < kTL) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int bb = 0; bb < kBB; ++bb)
              red[((warp * 4 + g) * kBB + bb) * kTL + lane] = acc[g][bb];
        }
        __syncthreads();

        if (cell) {
          float pre[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float rec = 0.f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w)
              rec += red[((w * 4 + g) * kBB + cb) * kTL + cu];
            pre[g] = gx[g] + rec + bv[g];
          }
          const float logf_ = log_sigmoid(pre[1]);
          const float m_new = fmaxf(logf_ + m, pre[0]);
          const float i_p = expf(pre[0] - m_new);
          const float f_p = expf(logf_ + m - m_new);
          const float c_new = f_p * c + i_p * tanhf(pre[2]);
          const float n_new = f_p * nn + i_p;
          const float h = 1.f / (1.f + expf(-pre[3])) * c_new
                          / fmaxf(n_new, 1e-6f);
          c_st[s_idx] = c_new;
          n_st[s_idx] = n_new;
          m_st[s_idx] = m_new;
          h_next[s_idx] = h;
          store(out + (static_cast<size_t>(row) * S + t) * d + j, h);
          if (save)
            save_step(save, pre, c_new, n_new, m_new, h,
                      (static_cast<size_t>(row) * S + t) * d + j,
                      static_cast<size_t>(B) * S * d);
        }
        __syncthreads();                // h_s and red are reused
      }
    }
    grid.sync();                        // h_t visible to every block
  }
}

// ---------------------------------------------------------------------------
// cluster path
// ---------------------------------------------------------------------------

constexpr int kCThreads = 256;
constexpr int kCWarps = kCThreads / 32;
constexpr int kCU = 32;                 // units per block
constexpr int kCKS = 2 * kCWarps;       // k-slices: 2 a warp (half-warps)
constexpr int kCMaxBlk = 512;           // 16 blocks a cluster
constexpr int kCKR = 16;                // k of a slice held in registers

// floats of shared memory: 4 mbarriers (2 halves x 2 parities, 8 floats),
// h (2 halves x 2 parities x blk x RB / 2), the staged h of this block (2
// halves x 32 x RB / 2), the partial sums of a half (16 slices x 4 gates x
// RB / 2 x 32) and R's shared part (4 gates x (blk - 16 KR) x 32)
__host__ __device__ constexpr size_t cluster_smem_floats(int blk, int rb,
                                                         int kr) {
  return 8 + static_cast<size_t>(2) * blk * rb + kCU * rb
         + static_cast<size_t>(kCKS) * 4 * (rb / 2) * kCU
         + static_cast<size_t>(4) * (blk - kCKS * kr) * kCU;
}

template <int N>
__device__ __forceinline__ void load_h(float* hv, const float* src) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(hv) = *reinterpret_cast<const float4*>(src);
  } else {
    *reinterpret_cast<float2*>(hv) = *reinterpret_cast<const float2*>(src);
  }
}

// grid (CS, H, ceil(B / RB)), cluster (CS, 1, 1): blockIdx.x is the rank in
// the cluster (units l0 = 32 x rank), blockIdx.y the head, blockIdx.z the
// batch-row group.  A lane takes 4 gates x 2 units (2up, 2up + 1, up = lane
// % 16) over one of 16 k-slices of blk / 16 (warp w, half-warp lane / 16),
// so that each h value it reads feeds 8 products and each R value RB / 2.
// The RB rows run as two halves of RH = RB / 2 rows in half-steps u = 2t +
// x (half x at step t), so that one half's h travels while the other half
// computes.  Half-step u waits on this block's mbarrier full[x][t-1 & 1]
// until every peer's h_x(t-1) slice has landed (the transaction count of
// CS slices), arms it for h_x(t+1), runs its product and cell, and sends
// h_x(t) to every peer (st.async, completing on the peer's full[x][t & 1]).
// A peer can only send h_x(t+1) into the buffer of h_x(t-1) after it has
// this block's h_x(t), which this block sends after its product has read
// that buffer.  kFloor: the same half-steps' exchange and waits with no
// product and no cell (the step floor, a measurement).
template <typename T, int RB, int KR, bool kFloor>
__global__ void __launch_bounds__(kCThreads, 1)
slstm_cluster_kernel(const T* __restrict__ gates, const float* __restrict__ r,
                     const float* __restrict__ bias, T* __restrict__ out,
                     int B, int S, int d, int H, int blk,
                     float* __restrict__ save) {
  constexpr int RH = RB / 2;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);   // [half][parity]
  float* h_s = reinterpret_cast<float*>(smem4) + 8;  // [half][parity][k][row]
  float* hloc = h_s + 2 * blk * RB;                // [half][unit][row]
  float* red = hloc + kCU * RB;                    // [slice][gate][row][unit]
  float* r_s = red + kCKS * 4 * RH * kCU;          // [gate][k'][unit]

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int up = lane % 16;                        // units 2up, 2up + 1
  const int ks = warp * 2 + lane / 16;             // this lane's k-slice
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = blockIdx.y;
  const int b0 = blockIdx.z * RB;
  const int l0 = rank * kCU;
  const int kh = blk / kCKS;                       // k of a slice
  const int kss = kh - KR;                         // of them in shared memory
  const int ksm = kCKS * kss;
  const int k0 = ks * kh;
  const size_t gate_stride = static_cast<size_t>(H) * blk * blk;
  const float* r_n = r + static_cast<size_t>(n) * blk * blk + l0;

  // R's columns of this block: registers ([gate][unit][k]), then shared
  // memory (k' = slice x kss + k - k0 - KR)
  float rr[4][2][KR > 0 ? KR : 1];
  if constexpr (!kFloor) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int uu = 0; uu < 2; ++uu)
#pragma unroll
        for (int kk = 0; kk < KR; ++kk)
          rr[g][uu][kk] = r_n[g * gate_stride
                              + static_cast<size_t>(k0 + kk) * blk + 2 * up
                              + uu];
    for (int e = tid; e < 4 * ksm * kCU; e += kCThreads) {
      const int g = e / (ksm * kCU), kp = (e / kCU) % ksm, u = e % kCU;
      const int k = (kp / kss) * kh + KR + kp % kss;
      r_s[e] = r_n[g * gate_stride + static_cast<size_t>(k) * blk + u];
    }
  }

  // the cell's thread: (row b0 + cb of half cx, unit l0 + cu)
  const int cb = tid / kCU, cu = tid % kCU;
  const int cx = cb / RH, ch = cb % RH;
  const int row = b0 + cb;
  const bool cell = tid < RB * kCU;
  const bool live = cell && row < B;
  const int j = n * blk + l0 + cu;
  const size_t d4 = static_cast<size_t>(4) * d;
  const T* g_row = gates + static_cast<size_t>(live ? row : 0) * S * d4 + j;
  T* o_row = out + static_cast<size_t>(live ? row : 0) * S * d + j;
  float bv[4], gx[4] = {0.f, 0.f, 0.f, 0.f};
  float c = 0.f, nn = 0.f, m = -1e30f;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    bv[g] = live && !kFloor ? bias[g * d + j] : 0.f;
    if (live && !kFloor) gx[g] = to_f32(g_row[g * d]);
  }
  // h_x(t) for t + 1 < S arrives from every peer: CS slices of 32 x RH
  const int slice_bytes = kCU * RH * static_cast<int>(sizeof(float));
  const int step_bytes = cs * slice_bytes;
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < 4; ++i)                  // h_x(0), h_x(1)
      if ((i & 1) + 1 < S) mbar_expect_tx(full + i, step_bytes);
  }
  cluster.sync();                       // every peer's barriers are up

  for (int u = 0; u < 2 * S; ++u) {
    const int t = u >> 1, x = u & 1;
    const bool mine = cell && cx == x;  // this thread's half runs now
    const int sender = x * RH * 32;     // arms half x's barriers
    // its gates of step t + 1 in flight through this half-step (issued
    // here, not where the cell reads them), and step t + 2's into L2
    typename Raw<T>::type gn[4];
    if (mine && live && !kFloor && t + 1 < S) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        load_early(gn + g, g_row + (t + 1) * d4 + g * d);
        if (t + 2 < S) prefetch_l2(g_row + (t + 2) * d4 + g * d);
      }
    }
    float* h_x = h_s + x * 2 * blk * RH;           // this half's 2 parities
    if (t > 0) {
      uint64_t* bar = full + x * 2 + ((t - 1) & 1);
      mbar_wait(bar, ((t - 1) >> 1) & 1);       // h_x(t-1) from every peer
      if (tid == sender && t + 2 < S) mbar_expect_tx(bar, step_bytes);
    }
    // the product: h_x(t-1) x this block's R columns
    float acc[4][2][RH];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int uu = 0; uu < 2; ++uu)
#pragma unroll
        for (int b = 0; b < RH; ++b) acc[g][uu][b] = 0.f;
    if (!kFloor && t > 0) {
      const float* hq = h_x + ((t - 1) & 1) * blk * RH + k0 * RH;
      const float* rs = r_s + (ks * kss) * kCU + 2 * up;
      const float* hs = hq + KR * RH;
      if (kss == KR) {
        // the two parts in step: the shared part's loads overlap the
        // register part's products
#pragma unroll
        for (int kk = 0; kk < KR; ++kk) {
          float hv[RH], hw[RH];
          load_h<RH>(hv, hq + kk * RH);
          load_h<RH>(hw, hs + kk * RH);
          float2 rv[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            rv[g] = *reinterpret_cast<const float2*>(
                rs + (g * ksm + kk) * kCU);
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int b = 0; b < RH; ++b) {
              acc[g][0][b] = fmaf(hv[b], rr[g][0][kk], acc[g][0][b]);
              acc[g][1][b] = fmaf(hv[b], rr[g][1][kk], acc[g][1][b]);
              acc[g][0][b] = fmaf(hw[b], rv[g].x, acc[g][0][b]);
              acc[g][1][b] = fmaf(hw[b], rv[g].y, acc[g][1][b]);
            }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < KR; ++kk) {
          float hv[RH];
          load_h<RH>(hv, hq + kk * RH);
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int uu = 0; uu < 2; ++uu)
#pragma unroll
              for (int b = 0; b < RH; ++b)
                acc[g][uu][b] = fmaf(hv[b], rr[g][uu][kk], acc[g][uu][b]);
        }
#pragma unroll 8
        for (int kk = 0; kk < kss; ++kk) {
          float hv[RH];
          load_h<RH>(hv, hs + kk * RH);
          float2 rv[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            rv[g] = *reinterpret_cast<const float2*>(
                rs + (g * ksm + kk) * kCU);
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int b = 0; b < RH; ++b) {
              acc[g][0][b] = fmaf(hv[b], rv[g].x, acc[g][0][b]);
              acc[g][1][b] = fmaf(hv[b], rv[g].y, acc[g][1][b]);
            }
        }
      }
    }
    // this lane's partial sums, in the order ks = 0..15 later
    if constexpr (!kFloor) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int b = 0; b < RH; ++b)
          *reinterpret_cast<float2*>(
              red + ((ks * 4 + g) * RH + b) * kCU + 2 * up) =
              make_float2(acc[g][0][b], acc[g][1][b]);
    }
    __syncthreads();                  // red complete
    float* hl = hloc + x * kCU * RH;
    if (mine) {
      float h = static_cast<float>(u);
      if constexpr (!kFloor) {
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float rec = 0.f;
#pragma unroll
          for (int w = 0; w < kCKS; ++w)
            rec += red[((w * 4 + g) * RH + ch) * kCU + cu];
          pre[g] = gx[g] + rec + bv[g];
        }
        const float logf_ = log_sigmoid(pre[1]);
        const float m_new = fmaxf(logf_ + m, pre[0]);
        const float i_p = expf(pre[0] - m_new);
        const float f_p = expf(logf_ + m - m_new);
        c = f_p * c + i_p * tanhf(pre[2]);
        nn = f_p * nn + i_p;
        m = m_new;
        h = live ? 1.f / (1.f + expf(-pre[3])) * c / fmaxf(nn, 1e-6f) : 0.f;
        if (live) store(o_row + static_cast<size_t>(t) * d, h);
        if (live && save)
          save_step(save, pre, c, nn, m, h,
                    (static_cast<size_t>(row) * S + t) * d + j,
                    static_cast<size_t>(B) * S * d);
        if (live && t + 1 < S) {
#pragma unroll
          for (int g = 0; g < 4; ++g) gx[g] = widen(gn[g]);
        }
      }
      hl[cu * RH + ch] = h;
    }
    // hloc complete.  Every warp waits for the cell: run beside the other
    // half's product, the cell warps lose the issue slots to it and the
    // whole step waits on them
    __syncthreads();
    // h_x(t) into every peer's buffer of parity t (units l0.. of the half's
    // rows): 16-byte asynchronous remote stores, every thread a share
    if (t + 1 < S) {
      constexpr int per = kCU * RH / 4;
      const uint32_t slot = smem_u32(h_x + ((t & 1) * blk + l0) * RH);
      const uint32_t bar = smem_u32(full + x * 2 + (t & 1));
      for (int e = tid; e < cs * per; e += kCThreads) {
        const int q = e / per, i = e % per;
        st_async(peer_u32(slot + 16 * i, q),
                 reinterpret_cast<const float4*>(hl)[i], peer_u32(bar, q));
      }
    }
    // half-step u done
  }
  cluster.sync();
  // the kernel's end: no peer writes into this block any more
}

template <typename T, int RB, int KR, bool kFloor>
cudaError_t cluster_config(int cs, int H, int B, int blk,
                           cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr, int* active) {
  return slstm_dev::cluster_launch_config(
      slstm_cluster_kernel<T, RB, KR, kFloor>,
      cluster_smem_floats(blk, RB, KR) * sizeof(float), kCThreads, cs, H, B,
      RB, stream, cfg, attr, active);
}

template <typename T, int RB, int KR, bool kFloor>
cudaError_t cluster_launch(const T* gates, const float* r, const float* b,
                           T* out, float* save, int B, int S, int d, int H,
                           cudaStream_t stream) {
  const int blk = d / H;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  cudaError_t e = cluster_config<T, RB, KR, kFloor>(
      blk / kCU, H, B, blk, stream, &cfg, &attr, &active);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, slstm_cluster_kernel<T, RB, KR, kFloor>,
                            gates, r, b, out, B, S, d, H, blk, save);
}

// the cluster layout for this shape: info = {path (1 cluster, 0 l2), rows a
// cluster RB, cluster size CS, clusters the card holds at once}
template <typename T, int KR>
cudaError_t choose_rb(int B, int d, int H, int* info) {
  const int blk = d / H, cs = blk / kCU;
  return slstm_dev::choose_cluster_rows(
      B, H, cs,
      [&](int rb, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
          int* active) {
        return rb == 8 ? cluster_config<T, 8, KR, false>(cs, H, B, blk,
                                                         nullptr, cfg, attr,
                                                         active)
                       : cluster_config<T, 4, KR, false>(cs, H, B, blk,
                                                         nullptr, cfg, attr,
                                                         active);
      },
      [&](int rb) { return cluster_smem_floats(blk, rb, KR) * sizeof(float); },
      info);
}

template <typename T, bool kFloor>
cudaError_t run_cluster(const T* gates, const float* r, const float* b,
                        T* out, float* save, int B, int S, int d, int H,
                        int* info, cudaStream_t stream) {
  const int blk = d / H;
  info[0] = 0;
  if (blk % kCU != 0 || blk > kCMaxBlk) return cudaSuccess;
  const bool kr = blk >= kCKS * kCKR;   // a whole register part per slice
  cudaError_t e = kr ? choose_rb<T, kCKR>(B, d, H, info)
                     : choose_rb<T, 0>(B, d, H, info);
  if (e != cudaSuccess || info[0] == 0) return e;
  if (info[1] == 8)
    return kr ? cluster_launch<T, 8, kCKR, kFloor>(gates, r, b, out, save, B,
                                                   S, d, H, stream)
              : cluster_launch<T, 8, 0, kFloor>(gates, r, b, out, save, B, S,
                                                d, H, stream);
  return kr ? cluster_launch<T, 4, kCKR, kFloor>(gates, r, b, out, save, B, S,
                                                 d, H, stream)
            : cluster_launch<T, 4, 0, kFloor>(gates, r, b, out, save, B, S, d,
                                              H, stream);
}

template <typename T>
int run_l2(const T* gates, const float* r, const float* b, T* out,
           float* scratch, int B, int S, int d, int H, cudaStream_t stream,
           float* save = nullptr) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || H <= 0 || d % H != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, max_smem = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);

  const int blk = d / H;
  const int n_tiles = H * ((blk + kTL - 1) / kTL);
  const size_t base = (static_cast<size_t>(kRedFloats) + kBB * blk)
                      * sizeof(float);
  const size_t with_r = base + static_cast<size_t>(4) * blk * kTL
                        * sizeof(float);
  auto kernel = slstm_sequence_kernel<T>;
  // how many blocks fit on the card at once with `smem` bytes each
  auto capacity = [&](size_t smem, int* blocks) -> cudaError_t {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    *blocks = per_sm * sms;
    return err;
  };
  int r_in_smem = 0, blocks = 0;
  size_t smem = base;
  if (with_r <= static_cast<size_t>(max_smem)) {
    e = capacity(with_r, &blocks);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (blocks >= n_tiles) {
      r_in_smem = 1;
      smem = with_r;
    }
  }
  if (!r_in_smem) {
    if (base > static_cast<size_t>(max_smem))
      return static_cast<int>(cudaErrorInvalidValue);
    e = capacity(base, &blocks);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = n_tiles < blocks ? n_tiles : blocks;

  const size_t bd = static_cast<size_t>(B) * d;
  float* h_buf = scratch;               // ping, pong
  float* c_st = scratch + 2 * bd;
  float* n_st = scratch + 3 * bd;
  float* m_st = scratch + 4 * bd;
  int blk_arg = blk;
  void* args[] = {&gates, &r, &b, &h_buf, &c_st, &n_st, &m_st, &out,
                  &B, &S, &d, &H, &blk_arg, &r_in_smem, &save};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(grid), dim3(kThreads), args, smem,
                                  stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const T* gates, const float* r, const float* b, T* out,
        float* scratch, float* save, int* info, int B, int S, int d, int H,
        cudaStream_t stream) {
  info[0] = info[1] = info[2] = info[3] = 0;
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || H <= 0 || d % H != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = run_cluster<T, false>(gates, r, b, out, save, B, S, d, H,
                                        info, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (info[0] == 1) return static_cast<int>(cudaGetLastError());
  return run_l2<T>(gates, r, b, out, scratch, B, S, d, H, stream, save);
}

}  // namespace

// scratch: 5 x B x d f32 (h ping, h pong, c, n, m), written before read, for
// the l2 path.  info (4 ints): {path (1 cluster, 0 l2), batch rows a cluster,
// cluster size, clusters the card holds at once}
extern "C" int slstm_sequence_f32(const float* gates, const float* r,
                                  const float* b, float* out, float* scratch,
                                  int* info, int B, int S, int d, int H,
                                  void* stream) {
  return run<float>(gates, r, b, out, scratch, nullptr, info, B, S, d, H,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int slstm_sequence_bf16(const void* gates, const float* r,
                                   const float* b, void* out, float* scratch,
                                   int* info, int B, int S, int d, int H,
                                   void* stream) {
  return run<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(gates), r, b,
                            static_cast<__nv_bfloat16*>(out), scratch,
                            nullptr, info, B, S, d, H,
                            static_cast<cudaStream_t>(stream));
}

// The same launches, also writing what the backward reads: save (8, B, S, d)
// f32, each step's pre-activations (i, f, z, o) and new c, n, m and h.  The
// arithmetic is the serving entries', so h has their bits.
extern "C" int slstm_sequence_save_f32(const float* gates, const float* r,
                                       const float* b, float* out,
                                       float* scratch, float* save, int* info,
                                       int B, int S, int d, int H,
                                       void* stream) {
  return run<float>(gates, r, b, out, scratch, save, info, B, S, d, H,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int slstm_sequence_save_bf16(const void* gates, const float* r,
                                        const float* b, void* out,
                                        float* scratch, float* save,
                                        int* info, int B, int S, int d,
                                        int H, void* stream) {
  return run<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(gates), r, b,
                            static_cast<__nv_bfloat16*>(out), scratch, save,
                            info, B, S, d, H,
                            static_cast<cudaStream_t>(stream));
}

// The step floor of the cluster path at this shape: the same launch, S steps
// of h exchange and cluster barriers with no product and no cell; nothing is
// read or written in global memory.  Fails with cudaErrorInvalidValue where
// the shape takes the l2 path.
extern "C" int slstm_step_floor(int* info, int B, int S, int d, int H,
                                void* stream) {
  info[0] = info[1] = info[2] = info[3] = 0;
  if (B <= 0 || S <= 0 || d <= 0 || H <= 0 || d % H != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = run_cluster<float, true>(nullptr, nullptr, nullptr, nullptr,
                                           nullptr, B, S, d, H, info,
                                           static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (info[0] != 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
