// What csrc/slstm.cu (B8, the sLSTM forward) and csrc/slstm_backward.cu
// (B8ᵀ, its backward) share: the cell's log_sigmoid (one function, so the
// backward's tie test of max(log_sigmoid(pre_f) + m, pre_i) sees the
// forward's bits), the dtype helpers, and the cluster paths' tools: mbarriers
// in shared memory, asynchronous remote stores into a peer block's shared
// memory (st.async, distributed shared memory) that complete on the peer's
// mbarrier, loads issued early, and the cluster launch's configuration.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace slstm_dev {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// rounded to nearest (__float2bfloat16_rn), as Tensor.to(torch.bfloat16)
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

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
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}
// the same shared-memory offset in block `rank` of the cluster
__device__ __forceinline__ uint32_t peer_u32(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}
// 16 bytes into a peer's shared memory, completing on the peer's mbarrier
// (an asynchronous remote store: the issuing thread does not wait for it)
__device__ __forceinline__ void st_async(uint32_t dst, float4 v,
                                         uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32"
      " [%0], {%1, %2, %3, %4}, [%5];" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(mbar)
      : "memory");
}

// a value's raw bits, loaded at this point of the program (volatile asm
// keeps the compiler from sinking the load to its first use) through the
// non-coherent path, and widened to f32 where the cell reads it
template <typename T> struct Raw { using type = float; };
template <> struct Raw<__nv_bfloat16> { using type = unsigned short; };
__device__ __forceinline__ void load_early(float* v, const float* p) {
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(*v) : "l"(p));
}
__device__ __forceinline__ void load_early(unsigned short* v,
                                           const __nv_bfloat16* p) {
  asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(*v) : "l"(p));
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// A cluster launch of `kernel`: grid (cs, H, ceil(B / rb)) of `threads`,
// clusters of (cs, 1, 1) blocks (over 8: the non-portable size), `smem`
// bytes of dynamic shared memory; *active is how many such clusters the
// card holds at once (cudaOccupancyMaxActiveClusters).  `cfg` points at
// `attr`, which must outlive the launch call.
template <typename Kernel>
cudaError_t cluster_launch_config(Kernel kernel, size_t smem, int threads,
                                  int cs, int H, int B, int rb,
                                  cudaStream_t stream,
                                  cudaLaunchConfig_t* cfg,
                                  cudaLaunchAttribute* attr, int* active) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess && cs > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cs, H, (B + rb - 1) / rb);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(active, kernel, cfg);
}

// The rows a cluster takes, 8 or 4: the fewer waves of clusters times rows
// at this shape.  config(rb, &cfg, &attr, &active) configures the launch at
// rb rows (a refused configuration is not that rb); smem_bytes(rb) is its
// shared memory.  info = {1, rb, cs, active} for the choice, left as it is
// (info[0] == 0) where neither fits.
template <typename Config, typename Smem>
cudaError_t choose_cluster_rows(int B, int H, int cs, Config config,
                                Smem smem_bytes, int* info) {
  int max_smem = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int best_cost = 0;
  for (int rb = 8; rb >= 4; rb /= 2) {
    if (smem_bytes(rb) > static_cast<size_t>(max_smem)) continue;
    int active = 0;
    e = config(rb, &cfg, &attr, &active);
    if (e != cudaSuccess) {
      cudaGetLastError();             // a refused configuration: not this rb
      continue;
    }
    if (active <= 0) continue;
    const int clusters = H * ((B + rb - 1) / rb);
    const int cost = (clusters + active - 1) / active * rb;
    if (best_cost == 0 || cost < best_cost) {
      best_cost = cost;
      info[0] = 1;
      info[1] = rb;
      info[2] = cs;
      info[3] = active;
    }
  }
  return cudaSuccess;
}

}  // namespace slstm_dev
