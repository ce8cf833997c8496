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
// needs the whole h of the step before: that latency floor (S grid-wide
// synchronisations) is not in the bound.
//
// Design: the TPU kernel keeps R resident in VMEM for the whole sequence
// and carries (h, c, n, m) across sequential grid steps.  Here one
// persistent cooperative launch walks the whole sequence, its blocks spread
// over the SMs.  A block owns tiles of 16 units l of one head n; with one
// tile per block (128 blocks at full width) it copies its R columns
// R[g, n, :, l0:l0+16] (4 x blk x 16 floats, 128 KB at blk = 512) into
// shared memory once and reads them from there at every step; when the
// tiles outnumber the blocks that fit on the card at once, or the columns
// do not fit, it reads them from L2 instead.  At each step, for each tile
// and 8 batch rows at a time, the cell's threads first load their gates,
// biases and state (which do not wait for h_{t-1}), then the block stages
// h_{t-1}[rows, n, :] in shared memory and its 256 threads split the blk-deep product 16 ways (thread =
// 16 k-slices x 16 units), each holding 4 gates x 8 rows of fp32 sums in
// registers; the two k-slices of a warp are added with a shuffle, the
// warps' partial sums through shared memory in a fixed order, and one
// thread per (row, unit) runs the cell, keeping c, n, m in f32 global state
// that only it touches and writing h to a ping-pong f32 buffer and to the
// output, rounded to nearest (__float2bfloat16_rn, as
// Tensor.to(torch.bfloat16)).  A grid-wide barrier (cooperative groups,
// which fences memory) then makes h_t visible to every block before step
// t + 1.  Step 0 starts from the constant state and skips the product.  No
// fast-math intrinsics: expf, log1pf, tanhf.
//
// The kernel allocates nothing (the wrapper passes the 5 x B x d f32
// scratch), launches on the caller's stream and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTL = 16;                 // units per tile
constexpr int kKS = kThreads / kTL;     // k-slices per block
constexpr int kWarps = kThreads / 32;
constexpr int kBB = 8;                  // batch rows per pass
constexpr int kRedFloats = kWarps * 4 * kBB * kTL;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
slstm_sequence_kernel(const T* __restrict__ gates,
                      const float* __restrict__ r,
                      const float* __restrict__ bias,
                      float* __restrict__ h_buf, float* __restrict__ c_st,
                      float* __restrict__ n_st, float* __restrict__ m_st,
                      T* __restrict__ out, int B, int S, int d, int H,
                      int blk, int r_in_smem) {
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
        }
        __syncthreads();                // h_s and red are reused
      }
    }
    grid.sync();                        // h_t visible to every block
  }
}

template <typename T>
int run(const T* gates, const float* r, const float* b, T* out,
        float* scratch, int B, int S, int d, int H, cudaStream_t stream) {
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
                  &B, &S, &d, &H, &blk_arg, &r_in_smem};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(grid), dim3(kThreads), args, smem,
                                  stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: 5 x B x d f32 (h ping, h pong, c, n, m), written before read
extern "C" int slstm_sequence_f32(const float* gates, const float* r,
                                  const float* b, float* out, float* scratch,
                                  int B, int S, int d, int H, void* stream) {
  return run<float>(gates, r, b, out, scratch, B, S, d, H,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int slstm_sequence_bf16(const void* gates, const float* r,
                                   const float* b, void* out, float* scratch,
                                   int B, int S, int d, int H, void* stream) {
  return run<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(gates), r, b,
                            static_cast<__nv_bfloat16*>(out), scratch, B, S,
                            d, H, static_cast<cudaStream_t>(stream));
}
