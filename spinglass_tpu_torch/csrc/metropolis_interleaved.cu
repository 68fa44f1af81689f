// K6 on Hopper: K1's sweep with each decision warp stepping NC replica
// chains in interleaved order (NC = 2 or 4).
//
// Replaces the Pallas TPU kernel spinglass_tpu/kernels/metropolis_pallas.py
// (_make_kernel_interleaved, driven by FusedSweep(interleave=n)). Makes
// exactly the decisions of K1 (metropolis_sweep.cu) and of a sequential
// sweep: every operation is per replica column, chains only partition them.
//
// Design. dense_sweep.cuh's tile_sweep_kernel, which is K1 at one chain per
// warp, at NC chains: one thread block of 8 warps owns a tile of RT = 8 * NC
// replica columns for the whole sweep; warp w owns the NC columns
// r0 + w*NC + c.
//   (1) Block fields: field_partials at RT = 8*NC. K1 holds acc[4 rows][8
//       columns] per thread; here a thread owns 32 / RT rows, so it still
//       holds 32 accumulators at RT = 16 and 32 (the register trap of a
//       wider tile), reads J as float2 / float, and unrolls 8 deep (K1 16).
//   (2) The B dependent decisions (decide_block): for each row the owner
//       lane decides for chain 0, chain 1, ... in program order, one shuffle
//       per chain broadcasts ds, and the lanes read J's row from shared
//       memory once and correct every chain that flipped. Chain A's shuffle
//       -> compare -> FMA latency hides under chain B's, and one
//       shared-memory read of J serves NC chains.
//
// What bounds it on the H100: the field phase streams all of J once per tile
// from L2, so a tile of 8*NC columns cuts J's L2 traffic per sweep NC-fold
// against K1 (8.6 GB -> 4.3 / 2.1 GB at Np=4096, R=1024). The grid is
// ceil(R / RT) thread blocks, one per SM: at R=1024, 64 (NC=2) or 32 (NC=4)
// of the 132 SMs, so what L2 saves the idle SMs may cost.
//
// Randomness and masks as in K1: Philox4x32-10 keyed by the 64-bit sweep
// seed with counter (spin, replica) unless u is given; rows with mask == 0
// get u = 2. Columns beyond R never flip and are never stored.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_sweep.cuh"

namespace {

template <int B, int NC>
void launch(int rule, dim3 grid, cudaStream_t stream, const float* J,
            const float* h, const float* mask, float* spins, const float* beta,
            const float* u, uint32_t k0, uint32_t k1,
            const unsigned long long* seed_ptr, float* de, int* cnt,
            int n_pad, int R) {
  // the field loop unrolled 8 deep, the decisions 2
  if (rule == 0) {
    sgt::tile_sweep_kernel<B, 0, NC, 8, 2><<<grid, 256, 0, stream>>>(
        J, h, mask, spins, beta, u, k0, k1, seed_ptr, de, cnt, n_pad, R);
  } else {
    sgt::tile_sweep_kernel<B, 1, NC, 8, 2><<<grid, 256, 0, stream>>>(
        J, h, mask, spins, beta, u, k0, k1, seed_ptr, de, cnt, n_pad, R);
  }
}

}  // namespace

extern "C" {

// One sweep on `stream`; the arguments of sgt_metropolis_sweep (K1, with
// seed_ptr) plus nchains in {2, 4}. Returns cudaGetLastError() after the
// launch.
int sgt_metropolis_interleaved(const float* J, const float* h,
                               const float* mask, float* spins,
                               const float* beta, const float* u,
                               unsigned long long seed,
                               const unsigned long long* seed_ptr, float* de,
                               int* cnt, int n_pad, int R, int block_size, int rule,
                               int nchains, void* stream) {
  if (R < 1 || n_pad < 128 || n_pad % 128 != 0 || n_pad % block_size != 0 ||
      rule < 0 || rule > 1 || reinterpret_cast<uintptr_t>(J) % 16 != 0 ||
      (nchains != 2 && nchains != 4) ||
      (block_size != 128 && block_size != 256))
    return (int)cudaErrorInvalidValue;
  const int rt = 8 * nchains;
  const dim3 grid((R + rt - 1) / rt);
  const uint32_t k0 = (uint32_t)(seed & 0xffffffffull);
  const uint32_t k1 = (uint32_t)(seed >> 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_size == 256) {
    if (nchains == 2)
      launch<256, 2>(rule, grid, s, J, h, mask, spins, beta, u, k0, k1,
                     seed_ptr, de, cnt, n_pad, R);
    else
      launch<256, 4>(rule, grid, s, J, h, mask, spins, beta, u, k0, k1,
                     seed_ptr, de, cnt, n_pad, R);
  } else {
    if (nchains == 2)
      launch<128, 2>(rule, grid, s, J, h, mask, spins, beta, u, k0, k1,
                     seed_ptr, de, cnt, n_pad, R);
    else
      launch<128, 4>(rule, grid, s, J, h, mask, spins, beta, u, k0, k1,
                     seed_ptr, de, cnt, n_pad, R);
  }
  return (int)cudaGetLastError();
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
