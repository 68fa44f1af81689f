// Random numbers and acceptance thresholds shared by the port's kernels
// (the dense sweeps K1, K5, K6, K7 through dense_sweep.cuh, K2
// sparse_sweep.cu, K3 sparse_thresholds.cu, K4 sparse_accept.cu, and the
// Swendsen-Wang kernels C2 sw_bonds.cu and C1 sw_labels.cu).
//
// Philox4x32-10 keyed by the 64-bit sweep seed (k0 = low word, k1 = high
// word). An output word x gives u = (2 * (x >> 9) + 1) / 2^24: exact in
// float32 and strictly inside (0, 1). Three streams:
//   dense kernels, philox_uniform: counter (row, replica, 0, 0), word 0 of
//     the four output words (kernels/metropolis_cuda.py:philox_uniforms);
//   sparse kernels K2, K3, K4, philox_uniform4: counter (sorted row,
//     replica >> 2, 0, 0), and the four output words are the uniforms of
//     replicas 4g, 4g+1, 4g+2, 4g+3, so one run of the ten rounds serves
//     four columns (kernels/metropolis_cuda.py:philox_uniforms4). The ten
//     rounds are most of a threshold's cost (K3 took 190 us at [10240, 4096]
//     with one word used, against 50 us to write its output);
//   Swendsen-Wang kernels C2 and C1, philox4x32: counter (site, replica >> 2,
//     slot, tag), the four words again the replicas 4g .. 4g+3; tag 0 the
//     bond uniform of an edge at its lower end's (site, slot), tag 1 the
//     ghost uniform (slot 0), tag 2 the cluster coin (slot 0, the word's top
//     bit) (kernels/metropolis_cuda.py:sw_philox_draws; csrc/sw_bonds.cu).
// All are computed in PyTorch too, so every kernel's draws can be
// reproduced on the CPU.
//
// The seed reaches a kernel by value (k0, k1), or in device memory: every
// kernel also takes `seed_ptr`, and where it is not null reads the seed
// there (device_seed) at its start. A launch captured in a CUDA graph then
// draws, at each replay, the seed its slot holds at that time.
//
// Thresholds are exp-free: a flip is accepted iff s * f < th, with
//   metropolis: th = ln(u) * nib
//   glauber:    th = (ln(u) - ln(1 - min(u, 0.999999))) * nib
// where nib = -0.5 / beta, and u >= 1 gives -inf (never accept). Built
// without --use_fast_math, so logf/log1pf match torch's CUDA log/log1p.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sgt {

constexpr float kGlauberUMax = 0.999999f;

// (k0, k1) from the 64-bit seed at p, where p is not null.
__device__ __forceinline__ void device_seed(const unsigned long long* p,
                                            uint32_t& k0, uint32_t& k1) {
  if (p != nullptr) {
    const unsigned long long s = __ldg(p);
    k0 = (uint32_t)(s & 0xffffffffull);
    k1 = (uint32_t)(s >> 32);
  }
}

// Raises a kernel's dynamic shared memory limit to `bytes` where `allowed`
// (the caller's static, one per kernel) is below it: cudaFuncSetAttribute
// runs at the first launch of a kernel at a size, which the drivers make
// before they capture a graph, and not at the launches after it.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

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

__device__ __forceinline__ float word_uniform(uint32_t x) {
  return (float)(((x >> 9) << 1) | 1u) * 5.9604644775390625e-08f;  // 2^-24
}

// The sparse stream: u[q] is the uniform of (sorted row, replica 4 * group + q).
__device__ __forceinline__ void philox_uniform4(uint32_t row, uint32_t group,
                                                uint32_t k0, uint32_t k1,
                                                float (&u)[4]) {
  uint32_t c0 = row, c1 = group, c2 = 0u, c3 = 0u;
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
  u[0] = word_uniform(c0);
  u[1] = word_uniform(c1);
  u[2] = word_uniform(c2);
  u[3] = word_uniform(c3);
}

// The four output words of counter (c0, c1, c2, c3): the Swendsen-Wang
// kernels' stream (sw_bonds.cu, sw_labels.cu) names all four counter words.
__device__ __forceinline__ void philox4x32(uint32_t c0, uint32_t c1,
                                           uint32_t c2, uint32_t c3,
                                           uint32_t k0, uint32_t k1,
                                           uint32_t (&x)[4]) {
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
  x[0] = c0;
  x[1] = c1;
  x[2] = c2;
  x[3] = c3;
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
