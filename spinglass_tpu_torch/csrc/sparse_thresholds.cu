// K3 on Hopper: acceptance thresholds th [NS, R] straight from Philox.
//
// Replaces the Pallas TPU kernel spinglass_tpu/kernels/sparse.py
// (make_threshold_call), which feeds the per-colour sweep
// (make_sorted_t_sweep) on the threshold path:
//
//   th[i, r] = mask[i] < 0 ? -inf : threshold(u(i, r), -0.5 / beta[r])
//
// with u from the sparse kernels' Philox4x32-10 stream (philox.cuh,
// philox_uniform4): keyed by the 64-bit sweep seed, counter (sorted row,
// replica >> 2), the four output words being the uniforms of four
// neighbouring replicas. K2 draws the same stream in its Philox mode and K4
// in both of its modes, so K2(seed) and the K4 path make the decisions of
// make_sorted_t_sweep(K3(seed)), and
// kernels/metropolis_cuda.py:philox_uniforms4 reproduces all three.
//
// What bounds it on the H100: writing th, NS * R * 4 bytes (168 MB at
// [10240, 4096], 50 us at 3.35 TB/s). The first version ran the ten Philox
// rounds per element and kept one of the four output words (190 us at that
// shape; the rounds bounded it). Now a thread owns four consecutive columns
// and walks rows: one run of the rounds, four thresholds, one 16-byte store
// (a warp writes 512 contiguous bytes). The thread block is [BX column
// groups] x [256 / BX rows], BX a power of two from 32 to 256 chosen from R
// by the launcher, so a narrow R (R = 128: 32 groups) keeps every lane busy
// and no index is divided. Where R is no multiple of 4 the rows are not
// 16-byte aligned and the four values are stored one by one, those beyond R
// dropped. Measured on the H100 (700 W), in turns against the first version:
// 92-94 us per call at [10240, 4096] against 189-199, 30-34 at [10240, 1024]
// against 50; 53% of the rate its bytes allow. What is left is instruction
// issue: a run of the rounds and four accurate logarithms are ~220
// instructions per four thresholds (logf has to match torch.log bit for bit,
// so the fast intrinsic is not an option).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;

template <int RULE, bool VEC>  // VEC: R % 4 == 0, one float4 store
__global__ void __launch_bounds__(THREADS)
sparse_thresholds_kernel(const float* __restrict__ mask,  // [NS] 0 / -inf
                         const float* __restrict__ beta,  // [R]
                         uint32_t k0, uint32_t k1,
                         const unsigned long long* __restrict__ seed_ptr,
                         float* __restrict__ th,          // [NS, R]
                         int n_sorted, int R, int bx_log2) {
  sgt::device_seed(seed_ptr, k0, k1);
  const int bx = 1 << bx_log2;
  const int group = blockIdx.x * bx + (threadIdx.x & (bx - 1));
  const int col = 4 * group;
  if (col >= R) return;
  float nib[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    nib[q] = col + q < R ? -0.5f / __ldg(beta + col + q) : 0.f;
  const int rows_per_block = THREADS >> bx_log2;
  for (int row = blockIdx.y * rows_per_block + (threadIdx.x >> bx_log2);
       row < n_sorted; row += gridDim.y * rows_per_block) {
    float t[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    if (!(__ldg(mask + row) < 0.f)) {
      float u[4];
      sgt::philox_uniform4((uint32_t)row, (uint32_t)group, k0, k1, u);
#pragma unroll
      for (int q = 0; q < 4; ++q) t[q] = sgt::threshold<RULE>(u[q], nib[q]);
    }
    float* out = th + (size_t)row * R + col;
    if (VEC) {
      *reinterpret_cast<float4*>(out) = make_float4(t[0], t[1], t[2], t[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col + q < R) out[q] = t[q];
    }
  }
}

}  // namespace

extern "C" {

// Fill th [n_sorted, R] on `stream`. Returns cudaGetLastError() after the
// launch (0 on success). mask [n_sorted], beta [R]; rule in {0, 1}. The
// seed is `seed`, or the one at seed_ptr (device memory) where not null.
int sgt_sparse_thresholds(const float* mask, const float* beta,
                          unsigned long long seed,
                          const unsigned long long* seed_ptr, float* th,
                          int n_sorted,
                          int R, int rule, void* stream) {
  if (R < 1 || n_sorted < 1 || rule < 0 || rule > 1)
    return (int)cudaErrorInvalidValue;
  const int groups = (R + 3) / 4;
  int bx_log2 = 5;  // 32 column groups per block row at least: a full warp
  while (bx_log2 < 8 && (1 << bx_log2) < groups) ++bx_log2;
  const int bx = 1 << bx_log2, rows_per_block = THREADS >> bx_log2;
  const int gx = (groups + bx - 1) / bx;
  // about 2048 blocks in all: every SM gets many, none is starved
  const int row_blocks = (n_sorted + rows_per_block - 1) / rows_per_block;
  const int gy = gx >= 2048 ? 1 : (2048 / gx < row_blocks ? 2048 / gx
                                                          : row_blocks);
  const dim3 grid(gx, gy);
  const uint32_t k0 = (uint32_t)(seed & 0xffffffffull);
  const uint32_t k1 = (uint32_t)(seed >> 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SGT_K3(RULE, VEC)                                       \
  sparse_thresholds_kernel<RULE, VEC><<<grid, THREADS, 0, s>>>( \
      mask, beta, k0, k1, seed_ptr, th, n_sorted, R, bx_log2)
  if (R % 4 == 0) {
    if (rule == 0) SGT_K3(0, true); else SGT_K3(1, true);
  } else {
    if (rule == 0) SGT_K3(0, false); else SGT_K3(1, false);
  }
#undef SGT_K3
  return (int)cudaGetLastError();
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
