// The ADC sum of one PQ code row, shared by beam_gather_adc.cu and
// pq_adc.cu:  sum_{i = 0 .. m-1} tab[i * k + code[i]], added in the order
// i = 0, 1, ..., m - 1 (the order of the plain versions in
// repro_torch/kernels/ref.py, so kernel and plain version agree bit for bit
// when the LUT entries are the same floats).
//
// Two forms:
//   * uint8 codes with m == 16 (the repo's database config): the row is
//     held in registers as four little-endian 32-bit words (code i is byte
//     i % 4 of word i / 4), loaded with one 16-byte load.  The caller
//     guarantees the row address is 16-byte aligned.
//   * any m, uint8 or int32 codes: a plain loop over the row in memory.
//
// tab points at one query's (m, k) LUT, in shared or global memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace adc {

struct Row16 {
  uint32_t w[4];

  __device__ __forceinline__ void load(const uint8_t* row) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }

  __device__ __forceinline__ float sum(const float* tab, int k) const {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t c = (w[i >> 2] >> ((i & 3) * 8)) & 0xFFu;
      acc += tab[i * k + static_cast<int>(c)];
    }
    return acc;
  }
};

template <typename CodeT>
__device__ __forceinline__ float sum_generic(const float* tab,
                                             const CodeT* row, int m, int k) {
  float acc = 0.f;
  for (int i = 0; i < m; ++i)
    acc += tab[i * k + static_cast<int>(__ldg(row + i))];
  return acc;
}

// whether rows of m uint8 codes starting at device address `base` (row r at
// base + r * m) take the Row16 form
inline bool row16(int m, uintptr_t base) {
  return m == 16 && (base & 15) == 0;
}

}  // namespace adc
