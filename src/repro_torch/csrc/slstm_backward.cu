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
// Design: B8's cooperative ("l2") path, transposed.  One persistent
// cooperative launch walks the sequence backwards, its blocks spread over
// the SMs.  A block owns tiles of 16 units k of one head n (the units whose
// drec it computes and whose cell backward it then runs); with one tile per
// block it copies R[g, n, k0:k0+16, :] (4 x blk x 16 floats, [gate][l][k])
// into shared memory once, else it reads R from L2.  At each step, for each
// tile and 8 batch rows at a time, the block stages dpre_{t+1}[rows, g, n, :]
// one gate at a time from L2 in shared memory, and its 256 threads split
// the 4 x blk-deep sum 16 ways (thread = 16 l-slices x 16 units), each
// holding 8 rows of fp32 sums; the warp's two slices are added with a
// shuffle, the warps' partial sums through shared memory in a fixed order,
// and one thread per (row, unit) runs the cell backward, keeping dc, dn, dm
// in f32 global state that only it touches and writing dpre_t to global
// memory.  A grid-wide barrier (cooperative groups, which fences memory)
// makes dpre_t visible to every block before step t - 1.  log_sigmoid is
// B8's own function, so a = log_sigmoid(pre_f) + m_{t-1} has the forward's
// bits and the tie test of max(a, pre_i) sees what the forward saw.  No
// fast-math intrinsics: expf, log1pf, tanhf.  The kernel allocates nothing
// (the wrapper passes the 3 x B x d f32 carry), launches on the caller's
// stream and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTL = 16;                 // units per tile
constexpr int kKS = kThreads / kTL;     // l-slices per block
constexpr int kWarps = kThreads / 32;
constexpr int kBB = 8;                  // batch rows per pass
constexpr int kRedFloats = kWarps * kBB * kTL;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// csrc/slstm.cu's, character for character
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

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
int run(const T* dy, const float* save, const float* r, float* dpre,
        T* dgates, float* carry, int B, int S, int d, int H,
        cudaStream_t stream) {
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

}  // namespace

// dy (B, S, d), save (8, B, S, d) f32, r (4, H, blk, blk) f32 -> dpre (B, S,
// 4d) f32 and, where dgates is not null, the same values in dy's dtype.
// carry: 3 x B x d f32 (dc, dn, dm), written before it is read.
extern "C" int slstm_backward_f32(const float* dy, const float* save,
                                  const float* r, float* dpre, float* dgates,
                                  float* carry, int B, int S, int d, int H,
                                  void* stream) {
  return run<float>(dy, save, r, dpre, dgates, carry, B, S, d, H,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int slstm_backward_bf16(const void* dy, const float* save,
                                   const float* r, float* dpre, void* dgates,
                                   float* carry, int B, int S, int d, int H,
                                   void* stream) {
  return run<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(dy), save, r,
                            dpre, static_cast<__nv_bfloat16*>(dgates), carry,
                            B, S, d, H, static_cast<cudaStream_t>(stream));
}
