// K5 on Hopper: K1's sweep, software-pipelined with warp specialisation.
//
// Replaces the Pallas TPU kernel spinglass_tpu/kernels/metropolis_pallas.py
// (_make_kernel_pipe, built by _build_call_pipe, driven by
// FusedSweep(pipelined=True)). Its algorithm, which makes exactly the
// decisions of a sequential sweep:
//
//   H_pre(0) = J[rows of block 0, :] @ s + h
//   for each row-block b (B = 128 or 256 spins):
//     H(b) = H_pre(b) + J[b, b-1] @ ds_{b-1}       (repair; none for b = 0)
//     H_pre(b+1) = J[rows of b+1, :] @ s + h       (s without block b's flips)
//     block b decides on H(b), as in K1            (ds_b = its spin changes)
//
// Design. One thread block of 16 warps owns 8 replica columns, as K1 does.
// Warps 8-15 are producers: they compute H_pre(b+1) with the shared field
// phase (dense_sweep.cuh: field_partials) while warps 0-7, one per replica,
// run block b's dependent decisions with K1's decide_block. The two groups use their own
// named barriers (bar.sync 1 and 2, 256 threads each) and their own shared
// scratch; H_pre is double-buffered in shared memory (the TPU kernel's
// hpa/hpb). Then the whole block meets at __syncthreads (the handover).
//
// The race, and what the design does about it: the producers read every
// spin row of the tile while the decision warps flip block b's rows. The
// decision warps therefore keep block b's new spins in registers (and its
// ds in shared memory) and store them only after the handover, when
// H_pre(b+1) is complete. H_pre(b+1) then misses exactly block b's flips,
// and all 512 threads repair it with J[b+1, b] @ ds_b (rows of J whose ds
// is 0 are skipped) before the next round: the JAX algorithm, exactly.
//
// What bounds it on the H100: as K1, the field phase streams all of J per
// 8-column tile (8.6 GB from L2 per sweep at Np=4096, R=1024); the pipeline
// can hide at most the decision phase (~5% of K1), and the 512-thread block
// caps each thread at 128 registers, so the producers unroll 4 deep where
// K1 unrolls 16.
//
// Randomness and masks as in K1: Philox4x32-10, counter (spin, replica),
// unless u is given; rows with mask == 0 get u = 2; columns beyond R never
// flip and are never stored.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_sweep.cuh"

namespace {

constexpr int RT = 8;            // replica columns per thread block
constexpr int GROUP = 256;       // threads per group (8 warps)
constexpr int THREADS = 2 * GROUP;

using ProducerSync = sgt::GroupSync<1, GROUP>;
using DecisionSync = sgt::GroupSync<2, GROUP>;

template <int B>
constexpr int smem_floats() {  // producer scratch, J rows, 2 H_pre, ds
  return sgt::kScratch + 32 * B + 2 * B * RT + B * RT;
}

// H_pre of the block at row i1 into out[B][RT] (producer warps only).
template <int B>
__device__ __forceinline__ void produce(const float* __restrict__ J,
                                        const float* __restrict__ h,
                                        const float* spins, int n_pad, int R,
                                        int r0, int i1, int t, float* pscr,
                                        float* out) {
  sgt::field_partials<B, RT, GROUP, 4>(J, spins, n_pad, R, r0, i1, t, pscr,
                                       ProducerSync());
  for (int e = t; e < B * RT; e += GROUP)
    out[e] = sgt::block_field<B, RT, GROUP>(pscr, e / RT, e % RT,
                                            h[i1 + e / RT]);
}

template <int B, int RULE>  // RULE 0: metropolis, 1: glauber
__global__ void __launch_bounds__(THREADS, 1)
pipelined_kernel(const float* __restrict__ J, const float* __restrict__ h,
                 const float* __restrict__ mask, float* spins,
                 const float* __restrict__ beta, const float* __restrict__ u,
                 uint32_t k0, uint32_t k1, float* __restrict__ de_out,
                 int* __restrict__ cnt_out, int n_pad, int R) {
  constexpr int FPL = B / 32;  // block rows per lane
  extern __shared__ __align__(16) float smem[];
  float* pscr = smem;                      // producers' scratch
  float* jst = pscr + sgt::kScratch;       // decisions: 32 rows of J [32][B]
  float* hp = jst + 32 * B;                // H_pre, two [B][RT] buffers
  float* dsb = hp + 2 * B * RT;            // block b's ds [B][RT]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool producer = warp >= 8;
  const int r0 = blockIdx.x * RT;
  const int col[1] = {r0 + warp};  // a decision warp's replica
  const bool live = !producer && col[0] < R;
  const float nib = live ? -0.5f / beta[col[0]] : 0.f;
  const int n_blocks = n_pad / B;
  float de_acc[1] = {0.f};
  int cnt_acc[1] = {0};

  if (producer)
    produce<B>(J, h, spins, n_pad, R, r0, 0, tid - GROUP, pscr, hp);
  __syncthreads();
  for (int b = 0; b < n_blocks; ++b) {
    const int i0 = b * B;
    float s[1][FPL];
    if (!producer) {
      // ---- block b's B dependent decisions, one warp per replica -----
      const float* hb = hp + (b & 1) * B * RT;
      float f[1][FPL], th[1][FPL];
#pragma unroll
      for (int k = 0; k < FPL; ++k) {
        f[0][k] = hb[(lane + 32 * k) * RT + warp];
        sgt::spin_state<RULE>(spins, u, mask, i0 + lane + 32 * k, col[0], live,
                              R, k0, k1, nib, s[0][k], th[0][k]);
      }
      sgt::decide_block<B, 1, GROUP, 4>(J, n_pad, i0, tid, jst, f, s, th,
                                        de_acc, cnt_acc, dsb + warp, RT,
                                        DecisionSync());
    } else if (b + 1 < n_blocks) {
      // ---- H_pre(b+1) from spins that do not hold block b's flips ----
      produce<B>(J, h, spins, n_pad, R, r0, i0 + B, tid - GROUP, pscr,
                 hp + ((b + 1) & 1) * B * RT);
    }
    __syncthreads();  // the handover: H_pre(b+1) and ds_b complete
    if (live) {
#pragma unroll
      for (int k = 0; k < FPL; ++k)
        spins[(size_t)(i0 + lane + 32 * k) * R + col[0]] = s[0][k];
    }
    if (b + 1 < n_blocks) {
      // ---- repair: H(b+1) = H_pre(b+1) + J[b+1, b] @ ds_b -------------
      float* hn = hp + ((b + 1) & 1) * B * RT;
      for (int e = tid; e < B * RT; e += THREADS) {
        const int k = e % B, r = e / B;  // a warp: 32 rows k, one column
        float v = hn[k * RT + r];
        for (int i = 0; i < B; ++i) {
          const float d = dsb[i * RT + r];
          if (d != 0.f) v = fmaf(__ldg(J + (size_t)(i0 + i) * n_pad + i0 + B + k), d, v);
        }
        hn[k * RT + r] = v;
      }
    }
    __syncthreads();  // H(b+1) repaired; block b's spins stored
  }
  if (!producer) sgt::store_totals<1>(de_acc, cnt_acc, col, R, de_out, cnt_out);
}

template <int B>
int launch(int rule, dim3 grid, cudaStream_t stream, const float* J,
           const float* h, const float* mask, float* spins, const float* beta,
           const float* u, uint32_t k0, uint32_t k1, float* de, int* cnt,
           int n_pad, int R) {
  const size_t bytes = sizeof(float) * smem_floats<B>();
  auto kernel = rule == 0 ? pipelined_kernel<B, 0> : pipelined_kernel<B, 1>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, bytes, stream>>>(J, h, mask, spins, beta, u, k0, k1,
                                           de, cnt, n_pad, R);
  return 0;
}

}  // namespace

extern "C" {

// One sweep on `stream`; the arguments of sgt_metropolis_sweep (K1).
// Returns cudaGetLastError() after the launch.
int sgt_metropolis_pipelined(const float* J, const float* h, const float* mask,
                             float* spins, const float* beta, const float* u,
                             unsigned long long seed, float* de, int* cnt,
                             int n_pad, int R, int block_size, int rule,
                             void* stream) {
  if (R < 1 || n_pad < 128 || n_pad % 128 != 0 || n_pad % block_size != 0 ||
      rule < 0 || rule > 1 || reinterpret_cast<uintptr_t>(J) % 16 != 0 ||
      (block_size != 128 && block_size != 256))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + RT - 1) / RT);
  const uint32_t k0 = (uint32_t)(seed & 0xffffffffull);
  const uint32_t k1 = (uint32_t)(seed >> 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = block_size == 256
      ? launch<256>(rule, grid, s, J, h, mask, spins, beta, u, k0, k1, de,
                    cnt, n_pad, R)
      : launch<128>(rule, grid, s, J, h, mask, spins, beta, u, k0, k1, de,
                    cnt, n_pad, R);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
