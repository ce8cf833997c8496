// sLSTM recurrence over a whole sequence, backward (B8ᵀ): the derivative of
// csrc/slstm.cu's forward, walked from the last step to the first.
//
// Replaces: no TPU kernel.  The JAX package differentiates its sLSTM by
// autodiff of a lax.scan over the cell (src/repro/models/recurrent.py,
// apply_slstm / _slstm_cell); the port's forward on the card is B8
// (slstm_sequence_kernel, src/repro/kernels/slstm.py:90), so a gradient
// through it needs this kernel.  It computes what autodiff of the cell
// gives:
//   dy (B, S, d) bf16 | f32, the cotangent of h, x save (8, B, S, d) f32
//   (B8's save entry: each step's pre_i, pre_f, pre_z, pre_o and new c, n,
//   m, h) x r (4, H, blk, blk) f32
//   -> dpre (B, S, 4d) f32, and dgates = dpre in dy's dtype.  For t = S-1..0,
//   with (dc, dn, dm) carried from step t + 1 (0 at S - 1), h_{t-1}'s
//   cotangent from the recurrence drec (0 at S - 1) and c_{-1} = n_{-1} =
//   0, m_{-1} = -1e30:
//     dh   = dy_t + drec
//     a    = log_sigmoid(pre_f) + m_{t-1};  i' = exp(pre_i - m_t);
//     f'   = exp(a - m_t);  nc = max(n_t, 1e-6)
//     dpre_o = dh c_t / nc sig(pre_o)(1 - sig(pre_o))
//     dct  = dc + dh sig(pre_o) / nc
//     dnt  = dn - dh sig(pre_o) c_t / nc^2 [n_t > 1e-6, 1/2 on a tie]
//     xf   = (dct c_{t-1} + dnt n_{t-1}) f';  xi = (dct tanh(pre_z) + dnt) i'
//     dpre_z = dct i' (1 - tanh^2);  dmt = dm - xf - xi
//     wa   = [a > pre_i], 1/2 on a tie (m_t = max(a, pre_i))
//     da   = xf + dmt wa;  dpre_i = xi + dmt (1 - wa)
//     dpre_f = da sig(-pre_f)
//     carry: dc = dct f', dn = dnt f', dm = da
//     drec for step t - 1: drec[n blk + k] = sum_{g, l} dpre[g d + n blk + l]
//                                           * R[g, n, k, l]
//   dr and db are one product and one sum over save's h and dpre after the
//   kernel (kernels/ref.py, slstm_param_grads).
//
// What bounds it on an H100: operations.  The reverse product is 2 * B * S
// * 4d * blk flops, as the forward's (137 GFLOP at B = 8, S = 2,048, d =
// 2,048, blk = 512: 2.05 ms at 67 TFLOP/s fp32), against 1.96 GB of save,
// dy, R, dpre and bf16 dgates read or written once (0.59 ms at 3.35 TB/s;
// 1.76 GB and 0.53 ms with fp32 gates, whose dgates is dpre); the S
// sequential steps add a latency floor that the bound does not count.
//
// Design: B8's two paths (csrc/slstm.cu), transposed.  Head n's drec
// needs only head n's dpre and batch rows never meet, so the work splits by
// (head, batch-row group) as the forward's does; the head width alone picks
// the path:
//
// * cluster (blk a multiple of 32, at most 512): one thread block cluster
//   of CS = blk / 32 blocks (16 at blk = 512) per (head n, group of RB
//   batch rows).  Block `rank` owns units j = 32 rank .. 32 rank + 31 of
//   head n and keeps R[g, n, :, j] (4 x blk x 32 floats, 256 KB at blk =
//   512: the columns B8's cluster block holds) on chip for the whole
//   sequence, the first KR = 16 units of each in registers (128 a thread),
//   the rest in shared memory (128 KB).  From its own units' dpre_t it
//   computes a partial drec for every k of the head, partial[k] = sum_{g, j
//   own} dpre_t[g, j] R[g, n, k, j], and sends each peer p the 32 k that p
//   owns (k in [32 p, 32 p + 32)): 32 x RB floats a peer and step, the bytes
//   of the forward's h exchange (gathering every peer's dpre instead would
//   move 4 gates x 32 x RB).  The product: thread = (group of 8 k, gate g),
//   each holding 8 k x RB / 2 f32 sums over its gate's 32 units, so each
//   staged dpre value it reads feeds 8 products and each R value RB / 2;
//   the 4 gates' sums meet by a reduce-scatter of two shuffles, which leaves
//   each thread 2 x RB / 2 finished values of one row, sent as 16-byte
//   asynchronous remote stores (st.async into distributed shared memory),
//   double-buffered by step parity, each completing on the peer's mbarrier,
//   whose transaction count says when all CS slices have landed.  The
//   receiver adds the CS partials in rank order (a fixed order: two calls
//   give the same bits), and one thread per (row, unit) runs the cell
//   backward with dc, dn, dm in registers for the whole sequence (no global
//   carry), writes dpre_t and dgates (32 contiguous units per row and gate)
//   and stages dpre_t for its block's product.  A cell's inputs (the save's
//   7 fields of step t, c, n, m of step t - 1 and dy_t) do not depend on the
//   recurrence and are loaded a step ahead.  The RB rows run as two halves a
//   half-step apart, so that one half's partials travel while the other half
//   computes.  One block barrier a half-step, none across the cluster inside
//   the loop, no grid barrier.  RB is 8 or 4, as B8's, by
//   cudaOccupancyMaxActiveClusters.  The launch is an ordinary cluster
//   launch; where it is refused the call fails (no other path is taken).
// * l2 (every other width: blk not a multiple of 32 or over 512): one
//   persistent cooperative launch walks the sequence backwards, its blocks
//   spread over the SMs.  A block owns tiles of 16 units k of one head n
//   (the units whose drec it computes and whose cell backward it then
//   runs); with one tile per block it copies R[g, n, k0:k0+16, :] (4 x blk x
//   16 floats, [gate][l][k]) into shared memory once, else it reads R from
//   L2.  At each step, for each tile and 8 batch rows at a time, the block
//   stages dpre_{t+1}[rows, g, n, :] one gate at a time from L2 in shared
//   memory, and its 256 threads split the 4 x blk-deep sum 16 ways (thread
//   = 16 l-slices x 16 units), each holding 8 rows of fp32 sums; the warp's
//   two slices are added with a shuffle, the warps' partial sums through
//   shared memory in a fixed order, and one thread per (row, unit) runs the
//   cell backward, keeping dc, dn, dm in f32 global state that only it
//   touches and writing dpre_t to global memory.  A grid-wide barrier
//   (cooperative groups, which fences memory) makes dpre_t visible to every
//   block before step t - 1.
//
// log_sigmoid is B8's own function (csrc/slstm_common.cuh), so a =
// log_sigmoid(pre_f) + m_{t-1} has the forward's bits and the tie test of
// max(a, pre_i) sees what the forward saw.  No fast-math intrinsics: expf,
// log1pf, tanhf.  The kernels allocate nothing (the wrapper passes the 3 x
// B x d f32 carry the l2 path uses), launch on the caller's stream and
// return cudaGetLastError().

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
constexpr int kKS = kThreads / kTL;     // l-slices per block
constexpr int kWarps = kThreads / 32;
constexpr int kBB = 8;                  // batch rows per pass
constexpr int kRedFloats = kWarps * kBB * kTL;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
slstm_backward_kernel(const T* __restrict__ dy,
                      const float* __restrict__ save,
                      const float* __restrict__ r, float* dpre,
                      T* __restrict__ dgates, float* __restrict__ carry,
                      int B, int S, int d, int H, int blk, int r_in_smem) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  float* red = smem;                    // [warp][row][unit]
  float* dp_s = smem + kRedFloats;      // [row][l], one gate
  float* r_s = dp_s + kBB * blk;        // [gate][l][unit], one tile

  const int tiles_per_head = (blk + kTL - 1) / kTL;
  const int n_tiles = H * tiles_per_head;
  const int tid = threadIdx.x;
  const int u = tid % kTL, ks = tid / kTL;
  const int lane = tid % 32, warp = tid / 32;
  const size_t bd = static_cast<size_t>(B) * d;
  const size_t bsd = bd * S;
  const size_t d4 = static_cast<size_t>(4) * d;
  const size_t gate_stride = static_cast<size_t>(H) * blk * blk;
  float* dc_st = carry;
  float* dn_st = carry + bd;
  float* dm_st = carry + 2 * bd;

  if (r_in_smem) {                      // one tile per block: blockIdx.x
    const int n = blockIdx.x / tiles_per_head;
    const int k0 = (blockIdx.x % tiles_per_head) * kTL;
    for (int i = tid; i < 4 * blk * kTL; i += kThreads) {
      const int g = i / (blk * kTL), l = (i / kTL) % blk, uu = i % kTL;
      r_s[i] = k0 + uu < blk
                   ? r[g * gate_stride
                       + (static_cast<size_t>(n) * blk + k0 + uu) * blk + l]
                   : 0.f;
    }
    __syncthreads();
  }

  for (int t = S - 1; t >= 0; --t) {
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int n = tile / tiles_per_head;
      const int k0 = (tile % tiles_per_head) * kTL;
      const int k = k0 + u;
      for (int b0 = 0; b0 < B; b0 += kBB) {
        // the cell's thread: (row b0 + cb, unit k0 + cu of head n)
        const int cb = tid / kTL, cu = tid % kTL;
        const int row = b0 + cb, ku = k0 + cu;
        const bool cell = tid < kBB * kTL && row < B && ku < blk;
        const int j = n * blk + ku;

        float acc[kBB];
#pragma unroll
        for (int bb = 0; bb < kBB; ++bb) acc[bb] = 0.f;
        if (t + 1 < S) {
          for (int g = 0; g < 4; ++g) {
#pragma unroll
            for (int bb = 0; bb < kBB; ++bb) {
              const bool valid = b0 + bb < B;
              const float* src =
                  dpre + (static_cast<size_t>(valid ? b0 + bb : 0) * S + t
                          + 1) * d4 + static_cast<size_t>(g) * d
                  + static_cast<size_t>(n) * blk;
              for (int l = tid; l < blk; l += kThreads)
                dp_s[bb * blk + l] = valid ? src[l] : 0.f;
            }
            __syncthreads();
            if (k < blk) {
              // R[g, n, k, l] for l: r_s[(g * blk + l) * kTL + u] or global
              const float* rc =
                  r_in_smem ? r_s + static_cast<size_t>(g) * blk * kTL + u
                            : r + g * gate_stride
                                  + (static_cast<size_t>(n) * blk + k) * blk;
              const int l_step = r_in_smem ? kTL : 1;
#pragma unroll 4
              for (int l = ks; l < blk; l += kKS) {
                const float rv = rc[static_cast<size_t>(l) * l_step];
#pragma unroll
                for (int bb = 0; bb < kBB; ++bb)
                  acc[bb] = fmaf(dp_s[bb * blk + l], rv, acc[bb]);
              }
            }
            __syncthreads();            // dp_s is restaged
          }
        }
        // the warp's two l-slices (lanes u and u + 16), then the warps in
        // order
#pragma unroll
        for (int bb = 0; bb < kBB; ++bb)
          acc[bb] += __shfl_down_sync(0xffffffffu, acc[bb], 16);
        if (lane < kTL) {
#pragma unroll
          for (int bb = 0; bb < kBB; ++bb)
            red[(warp * kBB + bb) * kTL + lane] = acc[bb];
        }
        __syncthreads();

        if (cell) {
          float drec = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            drec += red[(w * kBB + cb) * kTL + cu];
          const size_t s_idx = static_cast<size_t>(row) * d + j;
          const size_t at = (static_cast<size_t>(row) * S + t) * d + j;
          const float gi = save[at], gf = save[bsd + at];
          const float gz = save[2 * bsd + at], go = save[3 * bsd + at];
          const float c = save[4 * bsd + at], nn = save[5 * bsd + at];
          const float m = save[6 * bsd + at];
          float cp = 0.f, np = 0.f, mp = -1e30f;
          if (t > 0) {
            cp = save[4 * bsd + at - d];
            np = save[5 * bsd + at - d];
            mp = save[6 * bsd + at - d];
          }
          float dc = 0.f, dn = 0.f, dm = 0.f;
          if (t + 1 < S) {
            dc = dc_st[s_idx];
            dn = dn_st[s_idx];
            dm = dm_st[s_idx];
          }
          const float dh = to_f32(dy[at]) + drec;
          const float a = log_sigmoid(gf) + mp;
          const float i_p = expf(gi - m);
          const float f_p = expf(a - m);
          const float tz = tanhf(gz);
          const float sg = sigmoid(go);
          const float nc = fmaxf(nn, 1e-6f);
          const float w_clamp = nn > 1e-6f ? 1.f : (nn == 1e-6f ? 0.5f : 0.f);
          const float dgo = dh * c / nc * sg * (1.f - sg);
          const float dct = dc + dh * sg / nc;
          const float dnt = dn - dh * sg * c / (nc * nc) * w_clamp;
          const float x_f = (dct * cp + dnt * np) * f_p;
          const float x_i = (dct * tz + dnt) * i_p;
          const float dgz = dct * i_p * (1.f - tz * tz);
          const float dmt = dm - x_f - x_i;
          const float w_a = a > gi ? 1.f : (a == gi ? 0.5f : 0.f);
          const float da = x_f + dmt * w_a;
          const float dgi = x_i + dmt * (1.f - w_a);
          const float dgf = da * sigmoid(-gf);
          dc_st[s_idx] = dct * f_p;
          dn_st[s_idx] = dnt * f_p;
          dm_st[s_idx] = da;
          const float dp[4] = {dgi, dgf, dgz, dgo};
          const size_t o = (static_cast<size_t>(row) * S + t) * d4 + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            dpre[o + static_cast<size_t>(g) * d] = dp[g];
            if (dgates) store(dgates + o + static_cast<size_t>(g) * d, dp[g]);
          }
        }
        __syncthreads();                // red is reused
      }
    }
    grid.sync();                        // dpre_t visible to every block
  }
}

template <typename T>
int run_l2(const T* dy, const float* save, const float* r, float* dpre,
           T* dgates, float* carry, int B, int S, int d, int H,
           cudaStream_t stream) {
  if (!carry) return static_cast<int>(cudaErrorInvalidValue);
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
  auto kernel = slstm_backward_kernel<T>;
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

  int blk_arg = blk;
  void* args[] = {&dy, &save, &r, &dpre, &dgates, &carry,
                  &B, &S, &d, &H, &blk_arg, &r_in_smem};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(grid), dim3(kThreads), args, smem,
                                  stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// cluster path
// ---------------------------------------------------------------------------

constexpr int kCThreads = 256;
constexpr int kCU = 32;                 // units per block
constexpr int kCMaxBlk = 512;           // 16 blocks a cluster
constexpr int kCK = 8;                  // k of a product thread
constexpr int kCKR = 16;                // units of R held in registers

// floats of shared memory: 4 mbarriers (2 halves x 2 parities, 8 floats),
// the partials received (2 halves x 2 parities x CS ranks x RB / 2 rows x
// 32 k), this block's staged dpre (2 halves x 32 units x (4 gates x RB / 2
// rows, padded by 4 against bank conflicts)) and R's shared part ((32 - KR)
// units x 2 x blk / 2 threads x 4 k)
__host__ __device__ constexpr int dloc_stride(int rh) { return 4 * rh + 4; }
__host__ __device__ constexpr size_t cluster_smem_floats(int blk, int rb,
                                                         int kr) {
  return 8 + static_cast<size_t>(2) * blk * rb
         + static_cast<size_t>(2) * kCU * dloc_stride(rb / 2)
         + static_cast<size_t>(kCU - kr) * 4 * blk;
}

template <int N>
__device__ __forceinline__ void load_rows(float* v, const float* src) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(src);
  } else {
    *reinterpret_cast<float2*>(v) = *reinterpret_cast<const float2*>(src);
  }
}

// where the partial for (row, k) of a peer's 32-k slice lies in the
// receiver's buffer: in the order of the senders' 16-byte stores, [store e
// of a lane][lane q][k group][4], so that the 16 lanes sending to one peer
// write 256 contiguous bytes a store (lane q of k group k / 8 holds the
// 2 RH values of [row][k % 8] from q x 2 RH on)
template <int RH>
__device__ __forceinline__ int slice_pos(int row, int k) {
  constexpr int QU = 2 * RH;
  const int f = row * kCK + k % kCK;
  return ((f % QU / 4 * 4 + f / QU) * 4 + k / kCK) * 4 + f % 4;
}

// grid (CS, H, ceil(B / RB)), cluster (CS, 1, 1): blockIdx.x is the rank in
// the cluster (units j0 = 32 x rank), blockIdx.y the head, blockIdx.z the
// batch-row group.  Iteration i walks step t = S - 1 - i.  The RB rows run
// as two halves of RH = RB / 2 rows in half-steps u = 2i + x (half x at
// iteration i).  Half-step u waits on this block's mbarrier full[x][i-1 &
// 1] until every peer's partial drec of half x for step t (sent at
// iteration i - 1) has landed (the transaction count of CS slices) and
// arms it for iteration i + 1's; the half's cell threads add the partials,
// run the cell backward and stage dpre_t; after one block barrier every
// thread runs its part of the product over the staged dpre_t and sends
// the partials for step t - 1 (st.async, completing on the peer's
// full[x][i & 1]).  A peer can only send iteration i + 1's partials into
// the buffer that iteration i's cells read after it has this block's
// iteration-i partials, which this block sends after those cells.  The
// product's thread (kg = tid / 4, q = tid % 4) takes k = 8 kg .. 8 kg + 7
// and gate q; with blk < 512 only the first blk / 2 threads run it.
// kFloor: the same half-steps' exchange and waits with no product and no
// cell (the step floor, a measurement).
template <typename T, int RB, int KR, bool kFloor>
__global__ void __launch_bounds__(kCThreads, 1)
slstm_backward_cluster_kernel(const T* __restrict__ dy,
                              const float* __restrict__ save,
                              const float* __restrict__ r,
                              float* __restrict__ dpre,
                              T* __restrict__ dgates, int B, int S, int d,
                              int H, int blk) {
  constexpr int RH = RB / 2;
  constexpr int KS = kCU - KR;                     // units of R in smem
  constexpr int JS = dloc_stride(RH);
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);   // [half][parity]
  // [half][parity][source rank][32 x RH at slice_pos]
  float* recv = reinterpret_cast<float*>(smem4) + 8;
  float* dloc = recv + 2 * blk * RB;               // [half][unit][gate][row]
  float* r_s = dloc + 2 * kCU * JS;                // [unit'][2][thread][4]

  const int tid = threadIdx.x;
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = blockIdx.y;
  const int b0 = blockIdx.z * RB;
  const int j0 = rank * kCU;
  const int nact = blk / 2;                        // product threads
  const size_t gate_stride = static_cast<size_t>(H) * blk * blk;
  const size_t bsd = static_cast<size_t>(B) * S * d;
  const size_t d4 = static_cast<size_t>(4) * d;

  // the product's thread: k = 8 kg .. 8 kg + 7 of head n, gate q
  const int kg = tid >> 2, q = tid & 3;
  const bool prod = tid < nact;
  // R[q, n, 8 kg + kk, j0 + jj]: registers for jj < KR, then shared memory
  float rr[KR][kCK];
  if constexpr (!kFloor) {
    const float* r_q = r + q * gate_stride
                       + (static_cast<size_t>(n) * blk + kCK * kg) * blk + j0;
#pragma unroll
    for (int jj = 0; jj < KR; ++jj)
#pragma unroll
      for (int kk = 0; kk < kCK; ++kk)
        rr[jj][kk] = prod ? r_q[static_cast<size_t>(kk) * blk + jj] : 0.f;
    for (int e = tid; e < KS * 8 * nact; e += kCThreads) {
      const int w = e % 4, th = (e / 4) % nact, hh = (e / (4 * nact)) % 2;
      const int jj = e / (8 * nact);
      r_s[e] = r[(th & 3) * gate_stride
                 + (static_cast<size_t>(n) * blk + kCK * (th >> 2) + 4 * hh
                    + w) * blk + j0 + KR + jj];
    }
  }

  // the cell's thread: (row b0 + cb of half cx, unit j0 + cu)
  const int cb = tid / kCU, cu = tid % kCU;
  const int cx = cb / RH, ch = cb % RH;
  const int row = b0 + cb;
  const bool cell = tid < RB * kCU;
  const bool live = cell && row < B;
  const int j = n * blk + j0 + cu;
  const size_t row_at = static_cast<size_t>(live ? row : 0) * S * d + j;
  const T* dy_row = dy + row_at;
  const float* sv = save + row_at;      // field f of step t: f bsd + t d
  const size_t row_o = static_cast<size_t>(live ? row : 0) * S * d4 + j;
  float* dp_row = dpre + row_o;
  T* dg_row = dgates ? dgates + row_o : nullptr;
  // carried from step t + 1, in registers for the whole sequence
  float dc = 0.f, dn = 0.f, dm = 0.f;
  // loaded a step ahead: pre_i, pre_f, pre_z, pre_o and dy of the next
  // step, c, n, m of the step before it (the next step's own c, n, m are
  // this step's c_{t-1}, n_{t-1}, m_{t-1}: cp, np, mp)
  float nx[4] = {0.f, 0.f, 0.f, 0.f}, nprev[3] = {0.f, 0.f, -1e30f};
  typename Raw<T>::type ndy{};
  float cp = 0.f, np = 0.f, mp = -1e30f;
  if (live && !kFloor) {
    const size_t at = static_cast<size_t>(S - 1) * d;
#pragma unroll
    for (int g = 0; g < 4; ++g) load_early(nx + g, sv + g * bsd + at);
    load_early(&ndy, dy_row + at);
    load_early(&cp, sv + 4 * bsd + at);
    load_early(&np, sv + 5 * bsd + at);
    load_early(&mp, sv + 6 * bsd + at);
    if (S > 1) {
#pragma unroll
      for (int f = 0; f < 3; ++f)
        load_early(nprev + f, sv + (4 + f) * bsd + at - d);
    }
  }

  // partials of half x for iteration i + 1 < S arrive from every peer: CS
  // slices of 32 x RH
  const int slice_bytes = kCU * RH * static_cast<int>(sizeof(float));
  const int step_bytes = cs * slice_bytes;
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < 4; ++i)         // iterations 0 and 1's partials
      if ((i & 1) + 1 < S) mbar_expect_tx(full + i, step_bytes);
  }
  cluster.sync();                       // every peer's barriers are up

  for (int u = 0; u < 2 * S; ++u) {
    const int i = u >> 1, x = u & 1;
    const int t = S - 1 - i;
    const int sender = x * RH * kCU;    // arms half x's barriers
    float* rv_x = recv + x * 2 * cs * RH * kCU;    // this half's 2 parities
    if (i > 0) {
      uint64_t* bar = full + x * 2 + ((i - 1) & 1);
      mbar_wait(bar, ((i - 1) >> 1) & 1);  // step t's partials, every peer
      if (tid == sender && i + 2 < S) mbar_expect_tx(bar, step_bytes);
    }
    float* dl = dloc + x * kCU * JS;
    if (cell && cx == x) {
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (!kFloor) {
        // step t's inputs (loaded a step ago), then step t - 1's in flight
        const float gi = nx[0], gf = nx[1], gz = nx[2], go = nx[3];
        const float c = cp, nn = np, m = mp;
        const float dyv = widen(ndy);
        cp = nprev[0];
        np = nprev[1];
        mp = nprev[2];
        if (live && t > 0) {
          const size_t at = static_cast<size_t>(t - 1) * d;
#pragma unroll
          for (int g = 0; g < 4; ++g) load_early(nx + g, sv + g * bsd + at);
          load_early(&ndy, dy_row + at);
          if (t > 1) {
#pragma unroll
            for (int f = 0; f < 3; ++f)
              load_early(nprev + f, sv + (4 + f) * bsd + at - d);
          } else {
            nprev[0] = nprev[1] = 0.f;
            nprev[2] = -1e30f;
          }
        }
        // drec: the CS partials in rank order
        float drec = 0.f;
        if (i > 0) {
          const float* rp = rv_x + ((i - 1) & 1) * cs * RH * kCU
                            + slice_pos<RH>(ch, cu);
          for (int p = 0; p < cs; ++p) drec += rp[p * RH * kCU];
        }
        if (live) {
          const float dh = dyv + drec;
          const float a = log_sigmoid(gf) + mp;
          const float i_p = expf(gi - m);
          const float f_p = expf(a - m);
          const float tz = tanhf(gz);
          const float sg = sigmoid(go);
          const float nc = fmaxf(nn, 1e-6f);
          const float w_clamp = nn > 1e-6f ? 1.f : (nn == 1e-6f ? 0.5f : 0.f);
          const float dgo = dh * c / nc * sg * (1.f - sg);
          const float dct = dc + dh * sg / nc;
          const float dnt = dn - dh * sg * c / (nc * nc) * w_clamp;
          const float x_f = (dct * cp + dnt * np) * f_p;
          const float x_i = (dct * tz + dnt) * i_p;
          const float dgz = dct * i_p * (1.f - tz * tz);
          const float dmt = dm - x_f - x_i;
          const float w_a = a > gi ? 1.f : (a == gi ? 0.5f : 0.f);
          const float da = x_f + dmt * w_a;
          const float dgi = x_i + dmt * (1.f - w_a);
          const float dgf = da * sigmoid(-gf);
          dc = dct * f_p;
          dn = dnt * f_p;
          dm = da;
          dp[0] = dgi;
          dp[1] = dgf;
          dp[2] = dgz;
          dp[3] = dgo;
          const size_t o = static_cast<size_t>(t) * d4;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            dp_row[o + static_cast<size_t>(g) * d] = dp[g];
            if (dg_row) store(dg_row + o + static_cast<size_t>(g) * d, dp[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) dl[cu * JS + g * RH + ch] = dp[g];
    }
    __syncthreads();                    // dpre_t of half x staged
    if (i + 1 < S) {
      // the partial drec for step t - 1: this block's dpre_t x R[g, n, k,
      // j own], 8 k x RH rows a thread over gate q's 32 units
      constexpr int NV = kCK * RH, QU = NV / 4;
      float z[QU];
#pragma unroll
      for (int e = 0; e < QU; ++e) z[e] = 0.f;
      if constexpr (!kFloor) {
        float acc[kCK][RH];
#pragma unroll
        for (int kk = 0; kk < kCK; ++kk)
#pragma unroll
          for (int b = 0; b < RH; ++b) acc[kk][b] = 0.f;
        if (prod) {
          const float* dq = dl + q * RH;
          const float4* rs4 = reinterpret_cast<const float4*>(r_s) + tid;
          // the two parts in step: the shared part's loads overlap the
          // register part's products
#pragma unroll
          for (int jj = 0; jj < (KR > KS ? KR : KS); ++jj) {
            if (jj < KR) {
              float dv[RH];
              load_rows<RH>(dv, dq + jj * JS);
#pragma unroll
              for (int kk = 0; kk < kCK; ++kk)
#pragma unroll
                for (int b = 0; b < RH; ++b)
                  acc[kk][b] = fmaf(dv[b], rr[jj][kk], acc[kk][b]);
            }
            if (jj < KS) {
              float dw[RH];
              load_rows<RH>(dw, dq + (KR + jj) * JS);
              const float4 ra = rs4[(2 * jj) * nact];
              const float4 rb = rs4[(2 * jj + 1) * nact];
              const float rv[kCK] = {ra.x, ra.y, ra.z, ra.w,
                                     rb.x, rb.y, rb.z, rb.w};
#pragma unroll
              for (int kk = 0; kk < kCK; ++kk)
#pragma unroll
                for (int b = 0; b < RH; ++b)
                  acc[kk][b] = fmaf(dw[b], rv[kk], acc[kk][b]);
            }
          }
        }
        // the 4 gates' sums (lanes q = 0..3 of a k group) by a
        // reduce-scatter of v = acc as [row][k]: lane q keeps v[q QU ..
        // q QU + QU), row q QU / 8, k 8 kg + q QU % 8 ..
        float v[NV];
#pragma unroll
        for (int b = 0; b < RH; ++b)
#pragma unroll
          for (int kk = 0; kk < kCK; ++kk) v[b * kCK + kk] = acc[kk][b];
        const bool hi = (q & 2) != 0, lo = (q & 1) != 0;
        float w[2 * QU];
#pragma unroll
        for (int e = 0; e < 2 * QU; ++e) {
          const float mine = hi ? v[2 * QU + e] : v[e];
          const float other = hi ? v[e] : v[2 * QU + e];
          w[e] = mine + __shfl_xor_sync(0xffffffffu, other, 2);
        }
#pragma unroll
        for (int e = 0; e < QU; ++e) {
          const float mine = lo ? w[QU + e] : w[e];
          const float other = lo ? w[e] : w[QU + e];
          z[e] = mine + __shfl_xor_sync(0xffffffffu, other, 1);
        }
      }
      // into the buffer of parity i of peer kg / 4, which owns these k:
      // 16-byte asynchronous remote stores
      if (prod) {
        const int peer = kg >> 2;
        const int rw = q * QU / kCK, k_local = (kg & 3) * kCK + q * QU % kCK;
        const float* slice = rv_x + ((i & 1) * cs + rank) * RH * kCU;
        const uint32_t bar = peer_u32(smem_u32(full + x * 2 + (i & 1)), peer);
#pragma unroll
        for (int e = 0; e < QU / 4; ++e)
          st_async(peer_u32(smem_u32(slice + slice_pos<RH>(
                                         rw, k_local + 4 * e)),
                            peer),
                   make_float4(z[4 * e], z[4 * e + 1], z[4 * e + 2],
                               z[4 * e + 3]),
                   bar);
      }
    }
    // half-step u done
  }
  cluster.sync();
  // the kernel's end: no peer writes into this block any more
}

template <typename T, int RB, bool kFloor>
cudaError_t cluster_config(int cs, int H, int B, int blk, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           int* active) {
  return cluster_launch_config(
      slstm_backward_cluster_kernel<T, RB, kCKR, kFloor>,
      cluster_smem_floats(blk, RB, kCKR) * sizeof(float), kCThreads, cs, H,
      B, RB, stream, cfg, attr, active);
}

template <typename T, int RB, bool kFloor>
cudaError_t cluster_launch(const T* dy, const float* save, const float* r,
                           float* dpre, T* dgates, int B, int S, int d, int H,
                           cudaStream_t stream) {
  const int blk = d / H;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  cudaError_t e = cluster_config<T, RB, kFloor>(blk / kCU, H, B, blk, stream,
                                                &cfg, &attr, &active);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(
      &cfg, slstm_backward_cluster_kernel<T, RB, kCKR, kFloor>, dy, save, r,
      dpre, dgates, B, S, d, H, blk);
}

bool takes_cluster(int blk) { return blk % kCU == 0 && blk <= kCMaxBlk; }

// the cluster path at this shape (takes_cluster): info = {1, rows a cluster
// RB, cluster size CS, clusters the card holds at once}; fails where no RB
// fits the card or the launch is refused
template <typename T, bool kFloor>
cudaError_t run_cluster(const T* dy, const float* save, const float* r,
                        float* dpre, T* dgates, int B, int S, int d, int H,
                        int* info, cudaStream_t stream) {
  const int blk = d / H, cs = blk / kCU;
  cudaError_t e = choose_cluster_rows(
      B, H, cs,
      [&](int rb, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
          int* active) {
        return rb == 8 ? cluster_config<T, 8, kFloor>(cs, H, B, blk, nullptr,
                                                      cfg, attr, active)
                       : cluster_config<T, 4, kFloor>(cs, H, B, blk, nullptr,
                                                      cfg, attr, active);
      },
      [&](int rb) {
        return cluster_smem_floats(blk, rb, kCKR) * sizeof(float);
      },
      info);
  if (e != cudaSuccess) return e;
  if (info[0] != 1) return cudaErrorNotSupported;
  e = info[1] == 8
          ? cluster_launch<T, 8, kFloor>(dy, save, r, dpre, dgates, B, S, d,
                                         H, stream)
          : cluster_launch<T, 4, kFloor>(dy, save, r, dpre, dgates, B, S, d,
                                         H, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int run(const T* dy, const float* save, const float* r, float* dpre,
        T* dgates, float* carry, int* info, int B, int S, int d, int H,
        cudaStream_t stream) {
  info[0] = info[1] = info[2] = info[3] = 0;
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || H <= 0 || d % H != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (takes_cluster(d / H))
    return static_cast<int>(run_cluster<T, false>(dy, save, r, dpre, dgates,
                                                  B, S, d, H, info, stream));
  return run_l2<T>(dy, save, r, dpre, dgates, carry, B, S, d, H, stream);
}

}  // namespace

// dy (B, S, d), save (8, B, S, d) f32, r (4, H, blk, blk) f32 -> dpre (B, S,
// 4d) f32 and, where dgates is not null, the same values in dy's dtype.
// The head width picks the path: a multiple of 32 up to 512 the cluster
// path (carry unused, may be null; a refused cluster launch fails the
// call), any other the l2 path, whose carry is 3 x B x d f32 (dc, dn, dm),
// written before it is read.  info (4 ints): {path (1 cluster, 0 l2), batch
// rows a cluster, cluster size, clusters the card holds at once}
extern "C" int slstm_backward_f32(const float* dy, const float* save,
                                  const float* r, float* dpre, float* dgates,
                                  float* carry, int* info, int B, int S,
                                  int d, int H, void* stream) {
  return run<float>(dy, save, r, dpre, dgates, carry, info, B, S, d, H,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int slstm_backward_bf16(const void* dy, const float* save,
                                   const float* r, float* dpre, void* dgates,
                                   float* carry, int* info, int B, int S,
                                   int d, int H, void* stream) {
  return run<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(dy), save, r,
                            dpre, static_cast<__nv_bfloat16*>(dgates), carry,
                            info, B, S, d, H,
                            static_cast<cudaStream_t>(stream));
}

// 1 where a head of width blk takes the cluster path (the call needs no
// carry), 0 where it takes the l2 path
extern "C" int slstm_backward_takes_cluster(int blk) {
  return takes_cluster(blk) ? 1 : 0;
}

// The step floor of the cluster path at this shape: the same launch, S
// steps of partial-sum exchange and block barriers with no product and no
// cell; nothing is read or written in global memory.  Fails with
// cudaErrorInvalidValue where the width takes the l2 path.
extern "C" int slstm_backward_step_floor(int* info, int B, int S, int d,
                                         int H, void* stream) {
  info[0] = info[1] = info[2] = info[3] = 0;
  if (B <= 0 || S <= 0 || d <= 0 || H <= 0 || d % H != 0
      || !takes_cluster(d / H))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run_cluster<float, true>(
      nullptr, nullptr, nullptr, nullptr, nullptr, B, S, d, H, info,
      static_cast<cudaStream_t>(stream)));
}
