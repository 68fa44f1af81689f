// K1 on Hopper: one exact sequential-equivalent dense Metropolis/Glauber sweep.
//
// Replaces the Pallas TPU kernel spinglass_tpu/kernels/metropolis_pallas.py
// (_make_kernel, built by _build_call, driven by FusedSweep). For every
// replica column it makes exactly the decisions of a sequential sweep over
// spins 0..Np-1:
//
//   for each row-block of B spins (B = 128 or 256), starting at row i0:
//     H[k, r] = sum_j J[i0+k, j] s[j, r] + h[i0+k]          (block fields)
//     for i in 0..B-1 (in order):
//       accept  <=>  s_i * H_i < th_i,  th = -ln(u)/(2 beta)
//                                    (glauber: -(ln u - ln(1-u))/(2 beta))
//       ds = accept ? -2 s_i : 0 ;  s_i += ds ;  H_k += J[i0+i, i0+k] ds
//   dE = -sum ds * H_at_decision ;  count = number of accepted flips
//
// Design. The TPU grid (replica tiles x row-blocks) runs in order, so block
// b+1 sees block b's flips. CUDA thread blocks run in no order, so here ONE
// thread block of 8 warps owns a tile of RT = 8 replica columns for the whole
// sweep and loops over the row-blocks itself; the grid is ceil(R / RT) tiles
// and nothing passes between thread blocks. The kernel is
// dense_sweep.cuh's tile_sweep_kernel at one chain per warp (K6 runs it at
// 2 and 4). For each row-block the tile
//   (1) computes its B x RT block fields (field_partials). Each thread owns
//       four consecutive rows and one of 1024/B slices of the j range, reads
//       J[j, i0+4q..+3] (J is symmetric) as one float4, so a warp reads 512
//       contiguous bytes per j, and does 32 FMAs per load against spins
//       staged in shared memory in chunks of 1024 rows. The slices' partial
//       sums are added in slice order, so the fields do not depend on timing;
//   (2) runs the B dependent decisions with one warp per replica
//       (decide_block): lane l keeps the fields of rows l, l+32, ... in
//       registers, the owner lane of row i decides, a warp shuffle broadcasts
//       ds, and every lane corrects its rows with J's row i, read from shared
//       memory where the block stages 32 rows of the diagonal block at a
//       time. A warp whose replica did not flip skips the correction (the
//       branch is uniform in the warp).
// Spins are read and written in the caller's [Np, R] float32 array, in
// place; they live in L2 between the two phases.
//
// Staggering. All thread blocks stream the same J. Read in the same order,
// they ask L2 for the same lines at the same moment; so each thread block
// starts at a chunk and a row of its own (rotated by blockIdx). Measured on
// the H100 at Np=4096, R=1024: 2521 -> 2027 us/sweep, and 1736 with the
// loop unrolled 16 deep under __launch_bounds__(256, 1).
// The rotation changes only the order of the float32 sums, and that order
// is fixed per thread block, so runs are deterministic.
//
// What bounds it on the H100: each tile streams all of J (Np^2 * 4 bytes)
// once per sweep, so at Np=4096, R=1024 the 128 tiles read 8.6 GB of J from
// L2 per sweep, with one thread block (8 warps) per SM to hide the latency.
// Phase (2) is a chain of Np dependent steps per tile. Tensor cores, sharing
// J tiles between thread blocks (clusters) and overlapping the two phases
// are work for later versions.
//
// Randomness. With u == nullptr the kernel draws its own uniforms with
// Philox4x32-10 keyed by the 64-bit sweep seed (philox.cuh); the counter is
// (global spin index, global replica index, 0, 0), so the stream does not
// depend on RT or B. Otherwise u is the caller's [Np, R] array. Either way
// rows with mask == 0 get u = 2, whose threshold is -inf.
//
// Precision. Exact float32 throughout; built without --use_fast_math so
// logf/log1pf match torch's CUDA log/log1p. Glauber clamps u at 0.999999 in
// the log1p term, as the Pallas kernel does (philox.cuh: threshold).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_sweep.cuh"

namespace {

constexpr int RT = 8;  // replica columns per thread block (= warps)

template <int B>
void launch(int rule, dim3 grid, cudaStream_t stream, const float* J,
            const float* h, const float* mask, float* spins, const float* beta,
            const float* u, uint32_t k0, uint32_t k1, float* de, int* cnt,
            int n_pad, int R) {
  // one chain per warp; the field loop unrolled 16 deep, the decisions 4
  if (rule == 0) {
    sgt::tile_sweep_kernel<B, 0, 1, 16, 4><<<grid, 256, 0, stream>>>(
        J, h, mask, spins, beta, u, k0, k1, de, cnt, n_pad, R);
  } else {
    sgt::tile_sweep_kernel<B, 1, 1, 16, 4><<<grid, 256, 0, stream>>>(
        J, h, mask, spins, beta, u, k0, k1, de, cnt, n_pad, R);
  }
}

}  // namespace

extern "C" {

// One sweep on `stream`. Returns cudaGetLastError() after the launch (0 on
// success). The caller checks shapes: J [n_pad, n_pad] (16-byte aligned),
// h and mask [n_pad], spins and u [n_pad, R] row-major, beta/de/cnt [R];
// n_pad a multiple of 128 and of block_size, block_size in {128, 256}, rule
// in {0, 1}. u == nullptr selects the in-kernel Philox stream.
int sgt_metropolis_sweep(const float* J, const float* h, const float* mask,
                         float* spins, const float* beta, const float* u,
                         unsigned long long seed, float* de, int* cnt,
                         int n_pad, int R, int block_size, int rule,
                         void* stream) {
  if (R < 1 || n_pad < 128 || n_pad % 128 != 0 || n_pad % block_size != 0 ||
      rule < 0 || rule > 1 || reinterpret_cast<uintptr_t>(J) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + RT - 1) / RT);
  const uint32_t k0 = (uint32_t)(seed & 0xffffffffull);
  const uint32_t k1 = (uint32_t)(seed >> 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_size == 256) {
    launch<256>(rule, grid, s, J, h, mask, spins, beta, u, k0, k1, de, cnt,
                n_pad, R);
  } else if (block_size == 128) {
    launch<128>(rule, grid, s, J, h, mask, spins, beta, u, k0, k1, de, cnt,
                n_pad, R);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
