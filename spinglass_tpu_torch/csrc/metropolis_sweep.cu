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
// and nothing passes between thread blocks. For each row-block the tile
//   (1) computes its B x RT block fields. Each thread owns four consecutive
//       rows and one of 1024/B slices of the j range, reads J[j, i0+4q..+3]
//       (J is symmetric) as one float4, so a warp reads 512 contiguous bytes
//       per j, and does 32 FMAs per load against spins staged in shared
//       memory in chunks of JC rows. The slices' partial sums are added in
//       slice order, so the fields do not depend on timing;
//   (2) runs the B dependent decisions with one warp per replica: lane l
//       keeps the fields of rows l, l+32, ... in registers, the owner lane of
//       row i decides, a warp shuffle broadcasts ds, and every lane corrects
//       its rows with J's row i, read from shared memory where the block
//       stages 32 rows of the diagonal block at a time. A warp whose replica
//       did not flip skips the correction (the branch is uniform in the warp).
// Spins are read and written in the caller's [Np, R] float32 array, in
// place; they live in L2 between the two phases.
//
// Staggering. All thread blocks stream the same J. Read in the same order,
// they ask L2 for the same lines at the same moment; so each thread block
// starts at a chunk and a row of its own (rotated by blockIdx). Measured on
// the H100 at Np=4096, R=1024: 2521 -> 2027 us/sweep, and 1736 with the
// loop unrolled 16 deep under __launch_bounds__(256, 1) (179 registers).
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
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int RT = 8;          // replica columns per thread block (= warps)
constexpr int THREADS = 32 * RT;
constexpr int JC = 1024;       // spin rows per staged chunk in the field phase
constexpr int SCRATCH = 8192;  // floats of shared scratch (32 KB), see below
constexpr unsigned kFull = 0xffffffffu;

template <int B, int RULE>  // RULE 0: metropolis, 1: glauber
__global__ void __launch_bounds__(THREADS, 1)
metropolis_sweep_kernel(const float* __restrict__ J,
                        const float* __restrict__ h,
                        const float* __restrict__ mask,
                        float* spins,  // [Np, R], updated in place
                        const float* __restrict__ beta,
                        const float* __restrict__ u,  // [Np, R] or nullptr
                        uint32_t k0, uint32_t k1,
                        float* __restrict__ de_out, int* __restrict__ cnt_out,
                        int n_pad, int R) {
  constexpr int QUADS = B / 4;              // four-row groups of the block
  constexpr int SLICES = THREADS / QUADS;   // j slices per group: 4 or 8
  constexpr int FPL = B / 32;               // block rows per lane
  // The scratch holds, one after another: the staged spin chunk [JC][RT],
  // the slices' partial fields [SLICES][B][RT], then J's rows for 32
  // decisions [32][B].
  static_assert(JC * RT <= SCRATCH && SLICES * B * RT <= SCRATCH &&
                32 * B <= SCRATCH, "shared scratch too small");
  __shared__ __align__(16) float scratch[SCRATCH];
  __shared__ float h_blk[B][RT + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * RT;
  const int col = r0 + warp;      // this warp's replica in phase (2)
  const bool live = col < R;
  const float nib = live ? -0.5f / beta[col] : 0.f;
  const int quad = tid % QUADS, slice = tid / QUADS;
  float de_acc = 0.f;
  int cnt_acc = 0;

  for (int i0 = 0; i0 < n_pad; i0 += B) {
    // ---- (1) block fields ------------------------------------------------
    float acc[4][RT];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[q][r] = 0.f;
    const int n_chunks = (n_pad + JC - 1) / JC;
    for (int c = 0; c < n_chunks; ++c) {
      const int j0 = ((c + (int)blockIdx.x) % n_chunks) * JC;
      const int len = min(JC, n_pad - j0);  // a multiple of 128
      __syncthreads();  // scratch free; earlier spin writes visible
      for (int e = tid; e < len * RT; e += THREADS) {
        const int rr = e % RT;
        scratch[e] = (r0 + rr < R) ? spins[(size_t)(j0 + e / RT) * R + r0 + rr]
                                   : 0.f;
      }
      __syncthreads();
      const int per = len / SLICES;
      const int jb = slice * per;
      const float4* jp =
          reinterpret_cast<const float4*>(J + (size_t)(j0 + jb) * n_pad + i0) +
          quad;
      const int rot = ((int)blockIdx.x * 16) % per;  // see "Staggering" above
      const size_t stride4 = (size_t)n_pad / 4;
      const float* sp = scratch + jb * RT;
#pragma unroll 16
      for (int jn = 0; jn < per; ++jn) {
        int jj = jn + rot;
        if (jj >= per) jj -= per;
        const float4 a = __ldg(jp + jj * stride4);
        const float4 sa = *reinterpret_cast<const float4*>(sp + jj * RT);
        const float4 sb = *reinterpret_cast<const float4*>(sp + jj * RT + 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[q][0] = fmaf(av[q], sa.x, acc[q][0]);
          acc[q][1] = fmaf(av[q], sa.y, acc[q][1]);
          acc[q][2] = fmaf(av[q], sa.z, acc[q][2]);
          acc[q][3] = fmaf(av[q], sa.w, acc[q][3]);
          acc[q][4] = fmaf(av[q], sb.x, acc[q][4]);
          acc[q][5] = fmaf(av[q], sb.y, acc[q][5]);
          acc[q][6] = fmaf(av[q], sb.z, acc[q][6]);
          acc[q][7] = fmaf(av[q], sb.w, acc[q][7]);
        }
      }
    }
    __syncthreads();  // every slice is done with the spin chunk
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < RT; ++r)
        scratch[(slice * B + 4 * quad + q) * RT + r] = acc[q][r];
    __syncthreads();
    for (int k = tid; k < B; k += THREADS) {
      const float hv = h[i0 + k];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float v = 0.f;
#pragma unroll
        for (int sl = 0; sl < SLICES; ++sl) v += scratch[(sl * B + k) * RT + r];
        h_blk[k][r] = v + hv;
      }
    }
    __syncthreads();

    // ---- (2) B dependent decisions, one warp per replica ----------------
    float f[FPL], s[FPL], th[FPL];
    if (live) {
#pragma unroll
      for (int t = 0; t < FPL; ++t) {
        const int row = i0 + lane + 32 * t;
        f[t] = h_blk[lane + 32 * t][warp];
        s[t] = spins[(size_t)row * R + col];
        float uu = u ? u[(size_t)row * R + col]
                     : sgt::philox_uniform((uint32_t)row, (uint32_t)col, k0, k1);
        if (!(mask[row] > 0.f)) uu = 2.f;
        th[t] = sgt::threshold<RULE>(uu, nib);
      }
    }
#pragma unroll
    for (int t0 = 0; t0 < FPL; ++t0) {
      __syncthreads();  // scratch free
      // stage J[i0 + 32 t0 + src, i0 .. i0 + B) for src = 0..31
      const float4* jsrc =
          reinterpret_cast<const float4*>(J + (size_t)(i0 + 32 * t0) * n_pad + i0);
      float4* jdst = reinterpret_cast<float4*>(scratch);
      for (int e = tid; e < 32 * B / 4; e += THREADS) {
        const int src = e / (B / 4), c4 = e % (B / 4);
        jdst[e] = __ldg(jsrc + (size_t)src * (n_pad / 4) + c4);
      }
      __syncthreads();
      if (live) {
#pragma unroll 4
        for (int src = 0; src < 32; ++src) {
          const float sv = s[t0], fv = f[t0];
          const bool accept = sv * fv < th[t0];
          const float ds = accept ? -2.f * sv : 0.f;
          const float dsb = __shfl_sync(kFull, ds, src);
          if (lane == src) {
            s[t0] = sv + ds;
            de_acc -= ds * fv;
            cnt_acc += accept ? 1 : 0;
          }
          if (dsb != 0.f) {
            const float* jrow = scratch + src * B + lane;
#pragma unroll
            for (int t = 0; t < FPL; ++t) f[t] = fmaf(jrow[32 * t], dsb, f[t]);
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int t = 0; t < FPL; ++t)
        spins[(size_t)(i0 + lane + 32 * t) * R + col] = s[t];
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    de_acc += __shfl_xor_sync(kFull, de_acc, off);
    cnt_acc += __shfl_xor_sync(kFull, cnt_acc, off);
  }
  if (lane == 0 && live) {
    de_out[col] = de_acc;
    cnt_out[col] = cnt_acc;
  }
}

template <int B>
void launch(int rule, dim3 grid, cudaStream_t stream, const float* J,
            const float* h, const float* mask, float* spins, const float* beta,
            const float* u, uint32_t k0, uint32_t k1, float* de, int* cnt,
            int n_pad, int R) {
  if (rule == 0) {
    metropolis_sweep_kernel<B, 0><<<grid, THREADS, 0, stream>>>(
        J, h, mask, spins, beta, u, k0, k1, de, cnt, n_pad, R);
  } else {
    metropolis_sweep_kernel<B, 1><<<grid, THREADS, 0, stream>>>(
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
