// K3 on Hopper: acceptance thresholds th [NS, R] straight from Philox.
//
// Replaces the Pallas TPU kernel spinglass_tpu/kernels/sparse.py
// (make_threshold_call), which feeds the per-colour sweep
// (make_sorted_t_sweep) when the single-call sweep K2 is not taken:
//
//   th[i, r] = mask[i] < 0 ? -inf : threshold(u(i, r), -0.5 / beta[r])
//
// with u from Philox4x32-10 keyed by the 64-bit sweep seed, counter (sorted
// row, replica): the stream K2 draws in its Philox mode, so K2(seed) makes
// the decisions of make_sorted_t_sweep(K3(seed)), and
// kernels/metropolis_cuda.py:philox_uniforms reproduces both (philox.cuh).
//
// What bounds it on the H100: the ten Philox rounds per element (integer
// multiplies), then writing th, NS * R * 4 bytes (168 MB at [10240, 4096]).
// A thread owns one replica column and walks rows (a grid-stride loop over
// blockIdx.y), so neighbouring threads write neighbouring addresses and no
// index is divided.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;

template <int RULE>
__global__ void __launch_bounds__(THREADS)
sparse_thresholds_kernel(const float* __restrict__ mask,  // [NS] 0 / -inf
                         const float* __restrict__ beta,  // [R]
                         uint32_t k0, uint32_t k1,
                         float* __restrict__ th,          // [NS, R]
                         int n_sorted, int R) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= R) return;
  const float nib = -0.5f / __ldg(beta + col);
  for (int row = blockIdx.y; row < n_sorted; row += gridDim.y) {
    float t = -INFINITY;
    if (!(__ldg(mask + row) < 0.f)) {
      t = sgt::threshold<RULE>(
          sgt::philox_uniform((uint32_t)row, (uint32_t)col, k0, k1), nib);
    }
    th[(size_t)row * R + col] = t;
  }
}

}  // namespace

extern "C" {

// Fill th [n_sorted, R] on `stream`. Returns cudaGetLastError() after the
// launch (0 on success). mask [n_sorted], beta [R]; rule in {0, 1}.
int sgt_sparse_thresholds(const float* mask, const float* beta,
                          unsigned long long seed, float* th, int n_sorted,
                          int R, int rule, void* stream) {
  if (R < 1 || n_sorted < 1 || rule < 0 || rule > 1)
    return (int)cudaErrorInvalidValue;
  // about 2048 blocks in all: every SM gets many, none is starved
  const int gx = (R + THREADS - 1) / THREADS;
  const int gy = gx >= 2048 ? 1 : (2048 / gx < n_sorted ? 2048 / gx : n_sorted);
  const dim3 grid(gx, gy);
  const uint32_t k0 = (uint32_t)(seed & 0xffffffffull);
  const uint32_t k1 = (uint32_t)(seed >> 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rule == 0) {
    sparse_thresholds_kernel<0><<<grid, THREADS, 0, s>>>(mask, beta, k0, k1,
                                                          th, n_sorted, R);
  } else {
    sparse_thresholds_kernel<1><<<grid, THREADS, 0, s>>>(mask, beta, k0, k1,
                                                          th, n_sorted, R);
  }
  return (int)cudaGetLastError();
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
