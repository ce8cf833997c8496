// PQ asymmetric distance scan: every query's LUT against every code row.
//
// Replaces: src/repro/kernels/pq_adc.py, pq_adc_kernel (Pallas body
// _adc_kernel):
//   lut (Q, m, k) f32 x codes (N, m) u8 | i32 -> out (Q, N) f32,
//   out[q, n] = sum_i lut[q, i, codes[n, i]], added in the order i = 0..m-1.
//
// What bounds it on an H100: bytes.  The output is Q * N * 4 bytes
// (256 MB at Q = 1024 against one 65,536-row chunk, or Q = 64 against 1M
// rows), against N * m code bytes and Q * m * k * 4 LUT bytes, and it
// does Q * N * m fp32 adds: m / 4 adds per output byte (4 at m = 16),
// under the card's fp32 rate over its memory rate (67 / 3.35 = 20).  So
// the floor is the output write.  The lookups come next: Q * N * m LUT
// reads from shared memory, 32 a 128-byte wavefront at best (0.128 ms at
// 1,024 x 65,536 x 16 on 132 SMs at 1.98 GHz).
//
// Design: the Pallas kernel turns the gather into a one-hot MXU
// contraction, a TPU workaround.  Here the LUT entries are read from shared
// memory, and the layout decides the bank conflicts.  Two paths:
//
// * query lanes (Q >= 32, uint8 codes, m % 4 == 0, rows 4-byte aligned,
//   k <= 256): the 32 lanes of a warp are 32 queries and read one code row
//   at a time, so the code is the same across the warp and the LUT tile is
//   query-minor, lut_s[(i * k + c) * 32 + q]: one lookup instruction reads
//   32 consecutive floats, one wavefront, with no conflict by construction.
//   A first kernel writes the LUTs in that layout, 32 queries a tile and
//   zeros past Q, into the caller's scratch (QT, m, k, 32).  The main kernel
//   is persistent (a block an SM) over tiles of 32 queries x 1,024 rows; its
//   8 warps hold 128 rows' sums each in registers (lane = query) while the
//   tile's LUT streams through shared memory two sub-spaces at a time
//   (2 x k x 32 floats, 64 KB at k = 256), cp.async double-buffered behind
//   the lookups.  The tile's codes arrive as loaded ([word][row]) and are
//   turned once a tile into [sub-space][row] bytes (byte permutes), so that
//   one broadcast 4-byte read brings the codes of 4 rows; a lookup is then
//   a byte permute, an address add, the shared load and the add.  Each
//   row's sum adds i = 0..m-1 in order.  A tile's sums leave through a
//   padded per-warp shared-memory transpose as 128-byte rows of
//   out[q, n0:n0+32] (streaming stores).  The next tile's first stage and
//   codes load during this tile's last stage and stores.  What holds it is
//   shared-memory traffic: the lookups' wavefronts plus a quarter for the
//   codes, a quarter for the LUT staging (512 KB a 1,024-row tile) and the
//   output transposes.
// * row lanes (every other shape: Q < 32, int32 codes, unaligned rows,
//   any m, any k): a block takes a tile of TQ = 4 queries x 4,096 code
//   rows: it copies the 4 LUTs (64 KB at m = 16, k = 256) into shared
//   memory once (or reads them from global memory past 200 KB), then each
//   of its 256 threads walks 16 rows: it loads a row's m codes into
//   registers and, for each of the 4 queries, sums m LUT reads and writes
//   out[q, n] (lanes on consecutive n: coalesced stores).  No lane idles at
//   small Q; the 32 lanes read one LUT row at 32 data-dependent offsets, so
//   about 3.5 lanes share the busiest bank for uniform codes.
//
// Both paths add the same floats in the same order (acc = 0, then i =
// 0..m-1): their outputs agree bit for bit with each other and with the
// plain version.  The kernels allocate nothing, launch on the caller's
// stream and return cudaGetLastError().  Codes must lie in [0, k).

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_row.cuh"

namespace {

// ---------------------------------------------------------------------------
// row-lane path
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;
constexpr int kTQ = 4;
constexpr int kMaxSmemBytes = 200 * 1024;

template <typename CodeT, bool kRow16, bool kSmem>
__global__ void __launch_bounds__(kThreads)
pq_adc_kernel(const float* __restrict__ lut, const CodeT* __restrict__ codes,
              float* __restrict__ out, int Q, int N, int m, int k) {
  extern __shared__ float4 lut_s4[];
  const int q0 = blockIdx.y * kTQ;
  const int nq = min(kTQ, Q - q0);
  const int mk = m * k;
  const float* lut_t = lut + static_cast<size_t>(q0) * mk;
  const float* tab = lut_t;
  if constexpr (kSmem) {
    // the tile's nq LUTs are one contiguous run of nq * m * k floats
    float* lut_s = reinterpret_cast<float*>(lut_s4);
    const int total = nq * mk;
    if ((total & 3) == 0 && (reinterpret_cast<uintptr_t>(lut_t) & 15) == 0) {
      const float4* src = reinterpret_cast<const float4*>(lut_t);
      for (int e = threadIdx.x; e < (total >> 2); e += kThreads)
        lut_s4[e] = __ldg(src + e);
    } else {
      for (int e = threadIdx.x; e < total; e += kThreads)
        lut_s[e] = __ldg(lut_t + e);
    }
    __syncthreads();
    tab = lut_s;
  }
  const int n_begin = static_cast<int>(blockIdx.x) * kRowsPerBlock;
  const int n_end = min(N, n_begin + kRowsPerBlock);
  for (int n = n_begin + static_cast<int>(threadIdx.x); n < n_end;
       n += kThreads) {
    const CodeT* c = codes + static_cast<size_t>(n) * m;
    float* o = out + static_cast<size_t>(q0) * N + n;
    if constexpr (kRow16) {
      adc::Row16 r;
      r.load(reinterpret_cast<const uint8_t*>(c));
      for (int qq = 0; qq < nq; ++qq)
        o[static_cast<size_t>(qq) * N] = r.sum(tab + qq * mk, k);
    } else {
      for (int qq = 0; qq < nq; ++qq)
        o[static_cast<size_t>(qq) * N] =
            adc::sum_generic(tab + qq * mk, c, m, k);
    }
  }
}

template <typename CodeT, bool kRow16>
int launch(const float* lut, const CodeT* codes, float* out, int Q, int N,
           int m, int k, cudaStream_t s) {
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock,
                  (Q + kTQ - 1) / kTQ);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kTQ) * m * k * sizeof(float);
  if (smem <= kMaxSmemBytes) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(pq_adc_kernel<CodeT, kRow16, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    pq_adc_kernel<CodeT, kRow16, true><<<grid, kThreads, smem, s>>>(
        lut, codes, out, Q, N, m, k);
  } else {
    pq_adc_kernel<CodeT, kRow16, false><<<grid, kThreads, 0, s>>>(
        lut, codes, out, Q, N, m, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// query-lane path
// ---------------------------------------------------------------------------

constexpr int kQThreads = 256;
constexpr int kQWarps = kQThreads / 32;
constexpr int kQRW = 128;                    // rows a warp (sums in registers)
constexpr int kQR = kQWarps * kQRW;          // rows a tile
constexpr int kQTQ = 32;                     // queries a tile (lane = query)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// a LUT entry by its shared-memory byte address (one LEA-able add a lookup)
__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

// lut (Q, E = m * k) -> lut_t (QT, E, 32), zeros past Q: a 32 x 32 tile
// through shared memory, both sides coalesced
__global__ void __launch_bounds__(256)
pq_adc_lut_kernel(const float* __restrict__ lut,
                       float* __restrict__ lut_t, int Q, int E) {
  __shared__ float tile[32][33];
  const int e0 = blockIdx.x * 32, qt = blockIdx.y;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int y = ty; y < 32; y += 8) {
    const int q = qt * 32 + y, e = e0 + tx;
    tile[y][tx] = q < Q && e < E ? lut[static_cast<size_t>(q) * E + e] : 0.f;
  }
  __syncthreads();
  for (int y = ty; y < 32; y += 8) {
    const int e = e0 + y;
    if (e < E)
      lut_t[(static_cast<size_t>(qt) * E + e) * 32 + tx] = tile[tx][y];
  }
}

// floats of shared memory: 2 LUT stages of 2 sub-spaces, 2 code tiles as
// loaded (m / 4 words x kQR rows), the tile's codes by sub-space (m x kQR
// bytes), and the per-warp 32 x 33 output transposes
__host__ __device__ constexpr size_t qlane_smem_floats(int m, int k) {
  return static_cast<size_t>(2) * 2 * k * kQTQ
         + static_cast<size_t>(3) * (m / 4) * kQR + kQWarps * 32 * 33;
}

__global__ void __launch_bounds__(kQThreads, 1)
pq_adc_qlane_kernel(const float* __restrict__ lut_t,
                    const uint8_t* __restrict__ codes,
                    float* __restrict__ out, int Q, int N, int m, int k,
                    int tiles_n, int tiles) {
  extern __shared__ float4 smem4[];
  const int stage_floats = 2 * k * kQTQ;
  const int mw = m / 4;
  float* lut_buf = reinterpret_cast<float*>(smem4);
  uint32_t* code_buf = reinterpret_cast<uint32_t*>(lut_buf + 2 * stage_floats);
  uint32_t* code_t = code_buf + 2 * mw * kQR;  // [i][row / 4], 4 rows a word
  float* epi = reinterpret_cast<float*>(code_t + mw * kQR);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_stages = m / 2;
  const int grid = static_cast<int>(gridDim.x);
  const int my_tiles = (tiles - static_cast<int>(blockIdx.x) + grid - 1) / grid;
  const int total = my_tiles * n_stages;
  const uint32_t* codes_w = reinterpret_cast<const uint32_t*>(codes);

  // stage gs: sub-spaces 2s, 2s + 1 of the block's tile gs / n_stages into
  // LUT buffer gs & 1, and with s = 0 the tile's codes into code buffer
  // (gs / n_stages) & 1; one cp.async group
  auto issue = [&](int gs) {
    const int jt = gs / n_stages, s = gs % n_stages;
    const int tile = static_cast<int>(blockIdx.x) + jt * grid;
    const int qt = tile / tiles_n, nt = tile % tiles_n;
    const float4* src = reinterpret_cast<const float4*>(
        lut_t + (static_cast<size_t>(qt) * m + 2 * s) * k * kQTQ);
    float4* dst = reinterpret_cast<float4*>(lut_buf + (gs & 1) * stage_floats);
    for (int e = tid; e < stage_floats / 4; e += kQThreads)
      cp_async16(dst + e, src + e);
    if (s == 0) {
      uint32_t* cdst = code_buf + (jt & 1) * mw * kQR;
      for (int e = tid; e < mw * kQR; e += kQThreads) {
        const int w = e / kQR, rr = e % kQR;
        const int nrow = nt * kQR + rr;
        const int valid = nrow < N;     // zeros past N: entry 0, in bounds
        cp_async4(cdst + e,
                  codes_w + static_cast<size_t>(valid ? nrow : 0) * mw + w,
                  valid ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  if (total > 0) issue(0);
  if (total > 1) issue(1);
  const uint32_t lut_u32 = smem_u32(lut_buf) + 4 * lane;
  int gs = 0;
  for (int jt = 0; jt < my_tiles; ++jt) {
    float acc[kQRW];
#pragma unroll
    for (int j = 0; j < kQRW; ++j) acc[j] = 0.f;
    for (int s = 0; s < n_stages; ++s, ++gs) {
      if (gs + 1 < total) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();                  // stage gs in shared memory
      if (s == 0) {
        // the tile's codes by sub-space: word (i, g) holds code i of rows
        // 4g .. 4g + 3, so that one broadcast read serves 4 lookups
        const uint32_t* raw = code_buf + (jt & 1) * mw * kQR;
        for (int e = tid; e < mw * (kQR / 4); e += kQThreads) {
          const int w = e / (kQR / 4), g = e % (kQR / 4);
          const uint32_t* a = raw + w * kQR + 4 * g;
          const uint32_t lo01 = __byte_perm(a[0], a[1], 0x5140);
          const uint32_t lo23 = __byte_perm(a[2], a[3], 0x5140);
          const uint32_t hi01 = __byte_perm(a[0], a[1], 0x7362);
          const uint32_t hi23 = __byte_perm(a[2], a[3], 0x7362);
          uint32_t* o = code_t + 4 * w * (kQR / 4) + g;
          o[0] = __byte_perm(lo01, lo23, 0x5410);
          o[kQR / 4] = __byte_perm(lo01, lo23, 0x7632);
          o[2 * (kQR / 4)] = __byte_perm(hi01, hi23, 0x5410);
          o[3 * (kQR / 4)] = __byte_perm(hi01, hi23, 0x7632);
        }
        __syncthreads();
      }
      // sub-spaces 2s and 2s + 1; entry c of lane q at byte offset
      // c * 128 + 4q of the stage's sub-space
      const uint32_t b0 = lut_u32 + (gs & 1) * stage_floats * 4;
      const uint32_t b1 = b0 + k * kQTQ * 4;
      const uint32_t* c0 = code_t + 2 * s * (kQR / 4) + warp * (kQRW / 4);
      const uint32_t* c1 = c0 + kQR / 4;
#pragma unroll
      for (int rg = 0; rg < kQRW / 4; ++rg) {
        const uint32_t w0 = c0[rg], w1 = c1[rg];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[4 * rg + jj] +=
              lds_f32(b0 + (__byte_perm(w0, 0, 0x4440 + jj) << 7));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[4 * rg + jj] +=
              lds_f32(b1 + (__byte_perm(w1, 0, 0x4440 + jj) << 7));
      }
      __syncthreads();                  // LUT buffer gs & 1 is free
      if (gs + 2 < total) issue(gs + 2);
    }
    // the tile's sums: lane = query, 128 rows a warp, out through a
    // 32 x 33 transpose as 128-byte row runs
    const int tile = static_cast<int>(blockIdx.x) + jt * grid;
    const int q0 = (tile / tiles_n) * kQTQ;
    const int n0 = (tile % tiles_n) * kQR + warp * kQRW;
    float* sc = epi + warp * 32 * 33;
#pragma unroll
    for (int cb = 0; cb < kQRW / 32; ++cb) {
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) sc[lane * 33 + jj] = acc[32 * cb + jj];
      __syncwarp();
      const int nrow = n0 + 32 * cb + lane;
      if (nrow < N) {
#pragma unroll 4
        for (int qq = 0; qq < kQTQ && q0 + qq < Q; ++qq)
          __stcs(out + static_cast<size_t>(q0 + qq) * N + nrow,
                 sc[qq * 33 + lane]);
      }
      __syncwarp();
    }
  }
}

int launch_qlane(const float* lut, const uint8_t* codes, float* out,
                 float* scratch, int Q, int N, int m, int k,
                 cudaStream_t s, bool* taken) {
  *taken = false;
  if (scratch == nullptr || Q < kQTQ || m % 4 != 0 || k > 256
      || (reinterpret_cast<uintptr_t>(codes) & 3) != 0)
    return static_cast<int>(cudaSuccess);
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = qlane_smem_floats(m, k) * sizeof(float);
  if (smem > static_cast<size_t>(max_smem))
    return static_cast<int>(cudaSuccess);
  const int qt = (Q + kQTQ - 1) / kQTQ;
  const int E = m * k;
  const dim3 tgrid((E + 31) / 32, qt);
  if (tgrid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  pq_adc_lut_kernel<<<tgrid, 256, 0, s>>>(lut, scratch, Q, E);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(pq_adc_qlane_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_n = (N + kQR - 1) / kQR;
  const long long tiles = static_cast<long long>(tiles_n) * qt;
  if (tiles > (1ll << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  pq_adc_qlane_kernel<<<grid, kQThreads, smem, s>>>(
      scratch, codes, out, Q, N, m, k, tiles_n, static_cast<int>(tiles));
  *taken = true;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// code_bytes: 1 = uint8 codes, 4 = int32 codes.  scratch: ceil(Q / 32) x 32
// x m x k floats for the query-lane path's LUTs, or null (then the row-lane
// path runs).  info[0]: the path taken, 1 query lanes, 0 row lanes.
extern "C" int pq_adc_f32(const float* lut, const void* codes, float* out,
                          float* scratch, int* info, int Q, int N, int m,
                          int k, int code_bytes, void* stream) {
  info[0] = 0;
  if (Q <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (m <= 0 || k <= 0 || (code_bytes != 1 && code_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 4)
    return launch<int32_t, false>(lut, static_cast<const int32_t*>(codes), out,
                                  Q, N, m, k, s);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  bool taken = false;
  const int e = launch_qlane(lut, c, out, scratch, Q, N, m, k, s, &taken);
  if (e != 0 || taken) {
    info[0] = taken ? 1 : 0;
    return e;
  }
  if (adc::row16(m, reinterpret_cast<uintptr_t>(codes)))
    return launch<uint8_t, true>(lut, c, out, Q, N, m, k, s);
  return launch<uint8_t, false>(lut, c, out, Q, N, m, k, s);
}
