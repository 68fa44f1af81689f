// K7 on Hopper: K1's sweep with the replicas folded onto the warp's lanes.
//
// Replaces the Pallas TPU kernel spinglass_tpu/kernels/metropolis_pallas.py
// (_make_kernel_folded, driven by FusedSweep(folded=True)). Makes exactly
// the decisions of a sequential sweep over spins 0..Np-1, per replica:
//
//   for each row-block of B spins (B = 128 or 256) at row i0:
//     H[k, r] = sum_j J[i0+k, j] s[j, r] + h[i0+k]               (block fields)
//     for each micro-block [lo, lo + C) of the block (C = 32):
//       for i in lo..lo+C-1: decide spin i on H[i, r]; an accepted flip
//         corrects H[k, r] += J[i0+k, i0+i] ds for k in i+1..lo+C-1 only
//       delayed update: H[k, r] += sum_{i in micro-block} J[i0+k, i0+i] ds_i
//         for the rows k >= lo + C of the block (the TPU kernel's
//         jbb_od[:, lo:hi] @ ds[lo:hi]; earlier rows are never read again)
//
// Design. The TPU folds replicas onto its vector unit's packed dimension;
// the GPU's packed dimension is the warp's 32 lanes, so here lane = replica.
// One thread block of 8 warps owns a tile of RT = 32 replica columns.
//   (1) Block fields: the shared field phase (dense_sweep.cuh) at RT = 32,
//       reduced into shared memory hf[B][32].
//   (2) Per micro-block, the block stages J's rows lo..lo+C-1 (the columns
//       of the block, by symmetry) in shared memory; warp 0 then decides:
//       lane r keeps its replica's C fields, spins and thresholds in
//       registers, decides row by row with no shuffle, and corrects its own
//       later rows with J values that all lanes read at one shared address
//       (a broadcast, no bank conflict). It writes its ds to shared memory.
//   (3) All 8 warps run the delayed update of the block's later rows in
//       shared memory, then the next micro-block starts.
// Spins are read and written in the caller's [Np, R] float32 array (the 32
// lanes touch 32 consecutive columns of a row: one 128-byte line).
//
// What bounds it on the H100: as K6 at 4 chains, the field phase streams J
// once per 32-column tile (2.1 GB of L2 traffic per sweep at Np=4096,
// R=1024, a quarter of K1's) on ceil(R / 32) SMs (32 of 132 at R=1024). The
// decisions run on one warp per SM while 7 wait, and the delayed updates
// add (B - C) * B / 2 FMAs per replica per block.
//
// Randomness and masks as in K1: Philox4x32-10, counter (spin, replica),
// unless u is given; rows with mask == 0 get u = 2; columns beyond R never
// flip and are never stored.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_sweep.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int RT = 32;        // replica columns per thread block (= lanes)
constexpr int C = 32;         // micro-block rows

template <int B>
constexpr int smem_floats() {  // scratch, hf[B][RT], dsm[C][RT]
  return sgt::kScratch + B * RT + C * RT;
}

template <int B, int RULE>  // RULE 0: metropolis, 1: glauber
__global__ void __launch_bounds__(THREADS, 1)
folded_kernel(const float* __restrict__ J, const float* __restrict__ h,
              const float* __restrict__ mask, float* spins,
              const float* __restrict__ beta, const float* __restrict__ u,
              uint32_t k0, uint32_t k1,
              const unsigned long long* __restrict__ seed_ptr,
              float* __restrict__ de_out, int* __restrict__ cnt_out,
              int n_pad, int R) {
  sgt::device_seed(seed_ptr, k0, k1);
  static_assert(C * B <= sgt::kScratch, "J rows of a micro-block fit");
  extern __shared__ __align__(16) float smem[];
  float* scratch = smem;                 // spin chunks, partials, J rows
  float* hf = smem + sgt::kScratch;      // [B][RT] block fields
  float* dsm = hf + B * RT;              // [C][RT] the micro-block's ds

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * RT;
  const int col = r0 + lane;
  const bool live = col < R;
  const float nib = live ? -0.5f / beta[col] : 0.f;
  float de_acc = 0.f;
  int cnt_acc = 0;

  for (int i0 = 0; i0 < n_pad; i0 += B) {
    // ---- (1) block fields into hf ------------------------------------
    sgt::field_partials<B, RT, THREADS, 8>(J, spins, n_pad, R, r0, i0, tid,
                                           scratch, sgt::BlockSync());
    for (int e = tid; e < B * RT; e += THREADS)
      hf[e] = sgt::block_field<B, RT, THREADS>(scratch, e / RT, e % RT,
                                               h[i0 + e / RT]);
    for (int lo = 0; lo < B; lo += C) {
      __syncthreads();  // hf complete; scratch free
      sgt::stage_j_rows<B, C, THREADS>(J, n_pad, i0 + lo, i0, tid, scratch);
      __syncthreads();
      // ---- (2) C dependent decisions, lane = replica -----------------
      if (warp == 0) {
        float f[C], s[C], th[C];
#pragma unroll
        for (int k = 0; k < C; ++k) {
          f[k] = hf[(lo + k) * RT + lane];
          sgt::spin_state<RULE>(spins, u, mask, i0 + lo + k, col, live, R, k0,
                                k1, nib, s[k], th[k]);
        }
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const bool accept = s[i] * f[i] < th[i];
          const float ds = accept ? -2.f * s[i] : 0.f;
          s[i] += ds;
          de_acc -= ds * f[i];
          cnt_acc += accept ? 1 : 0;
          dsm[i * RT + lane] = ds;
          const float* jrow = scratch + i * B + lo;  // J[lo+i, lo+k] = J[lo+k, lo+i]
#pragma unroll
          for (int k = i + 1; k < C; ++k) f[k] = fmaf(jrow[k], ds, f[k]);
        }
        if (live) {
#pragma unroll
          for (int k = 0; k < C; ++k)
            spins[(size_t)(i0 + lo + k) * R + col] = s[k];
        }
      }
      __syncthreads();
      // ---- (3) delayed update of the rows after the micro-block ------
      for (int k = lo + C + warp; k < B; k += THREADS / 32) {
        float v = hf[k * RT + lane];
#pragma unroll 8
        for (int i = 0; i < C; ++i)
          v = fmaf(scratch[i * B + k], dsm[i * RT + lane], v);
        hf[k * RT + lane] = v;
      }
    }
  }
  if (warp == 0 && live) {
    de_out[col] = de_acc;
    cnt_out[col] = cnt_acc;
  }
}

template <int B>
int launch(int rule, dim3 grid, cudaStream_t stream, const float* J,
           const float* h, const float* mask, float* spins, const float* beta,
           const float* u, uint32_t k0, uint32_t k1,
           const unsigned long long* seed_ptr, float* de, int* cnt,
           int n_pad, int R) {
  const size_t bytes = sizeof(float) * smem_floats<B>();
  auto kernel = rule == 0 ? folded_kernel<B, 0> : folded_kernel<B, 1>;
  static size_t allowed[2] = {0, 0};  // per rule
  const cudaError_t err = sgt::allow_smem(kernel, bytes, allowed[rule]);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, bytes, stream>>>(J, h, mask, spins, beta, u, k0, k1,
                                           seed_ptr, de, cnt, n_pad, R);
  return 0;
}

}  // namespace

extern "C" {

// One sweep on `stream`; the arguments of sgt_metropolis_sweep (K1, with
// seed_ptr) plus micro, which must be 32. Returns cudaGetLastError() after the launch.
int sgt_metropolis_folded(const float* J, const float* h, const float* mask,
                          float* spins, const float* beta, const float* u,
                          unsigned long long seed,
                          const unsigned long long* seed_ptr, float* de,
                          int* cnt, int n_pad, int R, int block_size, int rule,
                          int micro, void* stream) {
  if (R < 1 || n_pad < 128 || n_pad % 128 != 0 || n_pad % block_size != 0 ||
      rule < 0 || rule > 1 || reinterpret_cast<uintptr_t>(J) % 16 != 0 ||
      micro != C || (block_size != 128 && block_size != 256))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + RT - 1) / RT);
  const uint32_t k0 = (uint32_t)(seed & 0xffffffffull);
  const uint32_t k1 = (uint32_t)(seed >> 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = block_size == 256
      ? launch<256>(rule, grid, s, J, h, mask, spins, beta, u, k0, k1,
                    seed_ptr, de, cnt, n_pad, R)
      : launch<128>(rule, grid, s, J, h, mask, spins, beta, u, k0, k1,
                    seed_ptr, de, cnt, n_pad, R);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
