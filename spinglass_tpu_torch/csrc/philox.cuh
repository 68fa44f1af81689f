// Random numbers and acceptance thresholds shared by the port's kernels
// (the dense sweeps K1, K5, K6, K7 through dense_sweep.cuh, K2
// sparse_sweep.cu, K3 sparse_thresholds.cu, K4 sparse_accept.cu).
//
// Philox4x32-10 keyed by the 64-bit sweep seed (k0 = low word, k1 = high
// word), counter (row, replica, 0, 0). Word 0 of the output gives
// u = (2 * (x >> 9) + 1) / 2^24: exact in float32 and strictly inside (0, 1).
// kernels/metropolis_cuda.py:philox_uniforms computes the same stream in
// PyTorch, so every kernel's draws can be reproduced on the CPU.
//
// Thresholds are exp-free: a flip is accepted iff s * f < th, with
//   metropolis: th = ln(u) * nib
//   glauber:    th = (ln(u) - ln(1 - min(u, 0.999999))) * nib
// where nib = -0.5 / beta, and u >= 1 gives -inf (never accept). Built
// without --use_fast_math, so logf/log1pf match torch's CUDA log/log1p.

#pragma once

#include <math.h>
#include <stdint.h>

namespace sgt {

constexpr float kGlauberUMax = 0.999999f;

__device__ __forceinline__ float philox_uniform(uint32_t c0, uint32_t c1,
                                                uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return (float)(((c0 >> 9) << 1) | 1u) * 5.9604644775390625e-08f;  // 2^-24
}

template <int RULE>  // 0: metropolis, 1: glauber
__device__ __forceinline__ float threshold(float u, float nib) {
  float tv;
  if (RULE == 0) {
    tv = logf(u) * nib;
  } else {
    tv = (logf(u) - log1pf(-fminf(u, kGlauberUMax))) * nib;
  }
  return u < 1.f ? tv : -INFINITY;
}

}  // namespace sgt
