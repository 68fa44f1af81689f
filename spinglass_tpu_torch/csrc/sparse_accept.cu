// K4 on Hopper: the fused per-colour accept of the threshold path.
//
// Replaces the Pallas TPU kernel spinglass_tpu/kernels/sparse.py
// (make_accept_call), which make_sorted_t_sweep_fused launches once per
// colour of the colour-sorted [NS, R] layout. For the colour's rows
// off .. off+mc-1 and every replica column r:
//
//   th = mask[row] < 0 ? -inf : threshold(u(row, r), -0.5 / beta[r])
//   accept  <=>  s * f < th ;  s -> -s on accept
//   dE[r] += 2 * sum of s * f over accepted rows ;  count[r] += accepted
//
// where the fields f [mc, R] float32 come from outside the kernel (the
// plain per-colour gathers) and the spins are updated in place. u is
// Philox4x32-10 keyed by the 64-bit sweep seed with counter (sorted row,
// replica): the stream of K3 (sparse_thresholds.cu) and of K2's Philox
// mode, through the same philox.cuh functions, so under one seed the K4
// path, the K3 path and K2 make the same decisions. This removes the
// [NS, R] threshold array (written by K3, read back per colour) and the
// per-colour elementwise passes of the plain sweep.
//
// Design. A thread block of 32 warps owns 32 replica columns: lane = column
// (a warp reads 32 consecutive fields, 128 bytes, and 32 consecutive spins
// of one row), warp g walks the rows g, g+32, ... Each thread sums its dE
// and count privately; the 32 partial sums of a column are then added in
// warp order by warp 0 and added to the column's [R] buffers, which the
// caller zeroes once per sweep. No float atomics: runs are deterministic,
// and the colours' launches on one stream add in colour order.
//
// What bounds it on the H100: the ten Philox rounds per element (as K3),
// then reading f (mc * R * 4 bytes) and the spins, with one thread block
// per 32 columns (128 at R=4096): 32 warps per SM to hide the loads, where
// K3 keeps 64. Measured on the H100 (700 W) for the 7 colours of one sweep
// at [10240, 4096]: 619.5 us with 16 warps per block, 368.8 with 32;
// K3 takes 189 us for the same Philox draws.
//
// Spins are int8 (the threshold path's default) or float32; the kernel
// widens them to float32 for the arithmetic and narrows at the store, as the
// Pallas kernel does. Exact float32, no --use_fast_math (philox.cuh).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int COLS = 32;    // replica columns per thread block (lanes)
constexpr int GROUPS = 32;  // row groups (warps)
constexpr int THREADS = COLS * GROUPS;

template <int RULE, typename S>  // RULE 0: metropolis, 1: glauber
__global__ void __launch_bounds__(THREADS)
sparse_accept_kernel(const float* __restrict__ f,     // [mc, R]
                     S* __restrict__ spins,           // [NS, R], rows off..
                     const float* __restrict__ mask,  // [NS] 0 / -inf
                     const float* __restrict__ beta,  // [R]
                     uint32_t k0, uint32_t k1,
                     float* __restrict__ de,          // [R], accumulated
                     int* __restrict__ cnt,           // [R], accumulated
                     int off, int mc, int R) {
  __shared__ float de_part[GROUPS][COLS];
  __shared__ int cnt_part[GROUPS][COLS];
  const int lane = threadIdx.x % COLS;
  const int g = threadIdx.x / COLS;
  const int col = blockIdx.x * COLS + lane;
  float sum = 0.f;
  int n = 0;
  if (col < R) {
    const float nib = -0.5f / __ldg(beta + col);
    for (int i = g; i < mc; i += GROUPS) {
      const int row = off + i;
      float th = -INFINITY;
      if (!(__ldg(mask + row) < 0.f))
        th = sgt::threshold<RULE>(
            sgt::philox_uniform((uint32_t)row, (uint32_t)col, k0, k1), nib);
      S* sp = spins + (size_t)row * R + col;
      const float s = (float)*sp;
      const float sf = s * __ldg(f + (size_t)i * R + col);
      if (sf < th) {
        *sp = (S)(-s);
        sum += sf;
        ++n;
      }
    }
  }
  de_part[g][lane] = sum;
  cnt_part[g][lane] = n;
  __syncthreads();
  if (g == 0 && col < R) {
    float v = 0.f;
    int m = 0;
#pragma unroll
    for (int k = 0; k < GROUPS; ++k) {
      v += de_part[k][lane];
      m += cnt_part[k][lane];
    }
    de[col] += 2.f * v;
    cnt[col] += m;
  }
}

template <typename S>
void launch(int rule, dim3 grid, cudaStream_t stream, const float* f,
            void* spins, const float* mask, const float* beta, uint32_t k0,
            uint32_t k1, float* de, int* cnt, int off, int mc, int R) {
  S* sp = static_cast<S*>(spins);
  if (rule == 0) {
    sparse_accept_kernel<0, S><<<grid, THREADS, 0, stream>>>(
        f, sp, mask, beta, k0, k1, de, cnt, off, mc, R);
  } else {
    sparse_accept_kernel<1, S><<<grid, THREADS, 0, stream>>>(
        f, sp, mask, beta, k0, k1, de, cnt, off, mc, R);
  }
}

}  // namespace

extern "C" {

// Accept one colour's rows off .. off+mc-1 on `stream`. f [mc, R] float32;
// spins [NS, R] int8 (spin_bytes 1) or float32 (spin_bytes 4); mask [NS];
// beta, de, cnt [R]. Returns cudaGetLastError() after the launch.
int sgt_sparse_accept(const float* f, void* spins, int spin_bytes,
                      const float* mask, const float* beta,
                      unsigned long long seed, float* de, int* cnt, int off,
                      int mc, int R, int rule, void* stream) {
  if (R < 1 || mc < 1 || off < 0 || rule < 0 || rule > 1 ||
      (spin_bytes != 1 && spin_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + COLS - 1) / COLS);
  const uint32_t k0 = (uint32_t)(seed & 0xffffffffull);
  const uint32_t k1 = (uint32_t)(seed >> 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (spin_bytes == 1) {
    launch<int8_t>(rule, grid, s, f, spins, mask, beta, k0, k1, de, cnt, off,
                   mc, R);
  } else {
    launch<float>(rule, grid, s, f, spins, mask, beta, k0, k1, de, cnt, off,
                  mc, R);
  }
  return (int)cudaGetLastError();
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
