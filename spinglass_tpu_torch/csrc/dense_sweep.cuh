// The pieces of the dense sweep that K1 (metropolis_sweep.cu) and its
// variants K5 (metropolis_pipelined.cu), K6 (metropolis_interleaved.cu) and
// K7 (metropolis_folded.cu) share. K1 and K6 are one kernel,
// tile_sweep_kernel, at NC = 1 and at NC = 2 or 4 chains per warp.
//
// The field phase, field_partials, for a replica tile of RT = 8, 16 or 32
// columns computed by a group of NT threads:
//
//   part[sl][k][r] = sum over slice sl of every chunk of J[i0+k, j] s[j, r0+r]
//
// Each thread owns QR = 32 / RT consecutive rows (so it always holds 32
// accumulators) and one slice of each staged chunk of spin rows; it reads
// J[j, i0 + QR*g .. +QR-1] (J is symmetric) as one QR-float vector, so a
// warp reads 32 * QR * 4 contiguous bytes per j. Chunks of JC = 8192 / RT
// spin rows are staged in shared memory; each thread block starts at a
// chunk and a row of its own (rotated by blockIdx.x), so tiles do not ask
// L2 for the same lines at once. The order of every float32 sum is fixed
// per thread block, so runs are deterministic. block_field adds the
// slices in slice order and then h.
//
// The decision phase, decide_block, for one warp that owns NC replica
// columns (its chains): lane l keeps, per chain, the field, spin and
// threshold of rows l, l+32, ... of the row-block in registers. For each
// row the owner lane decides chain 0, 1, ... in program order, one shuffle
// per chain broadcasts ds, and the lanes read J's row once from shared
// memory and correct every chain that flipped. Chain A's shuffle -> compare
// -> FMA latency hides under chain B's.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace sgt {

constexpr int kScratch = 8192;  // floats (32 KB) of shared scratch per group
constexpr unsigned kFull = 0xffffffffu;

template <int Q> struct RowVec;
template <> struct RowVec<4> { using T = float4; };
template <> struct RowVec<2> { using T = float2; };
template <> struct RowVec<1> { using T = float; };

__device__ __forceinline__ void unpack(const float4& a, float* v) {
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void unpack(const float2& a, float* v) {
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void unpack(const float& a, float* v) { v[0] = a; }

struct BlockSync {  // the whole thread block
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

template <int ID, int N>  // one named barrier for a group of N threads
struct GroupSync {
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;" ::"r"(ID), "r"(N) : "memory");
  }
};

template <int B, int RT, int NT>
struct FieldShape {
  static constexpr int QR = 32 / RT;            // rows per thread
  static constexpr int GROUPS = B / QR;         // row groups of the block
  static constexpr int SLICES = NT / GROUPS;    // j slices per row group
  static constexpr int JC = kScratch / RT;      // spin rows per chunk
  static_assert(RT == 8 || RT == 16 || RT == 32, "tile of 8, 16 or 32");
  static_assert(SLICES >= 1 && SLICES * GROUPS == NT, "thread mapping");
  static_assert(SLICES * B * RT <= kScratch, "partials fit the scratch");
};

// Leaves part[SLICES][B][RT] in `scratch` (the caller's group has passed
// a barrier after the write). t is the thread's index in its group;
// n_pad is a multiple of 128 and J is 16-byte aligned.
template <int B, int RT, int NT, int UNROLL, class Sync>
__device__ __forceinline__ void field_partials(
    const float* __restrict__ J, const float* spins, int n_pad, int R,
    int r0, int i0, int t, float* scratch, Sync sync) {
  using S = FieldShape<B, RT, NT>;
  constexpr int QR = S::QR, JC = S::JC;
  using V = typename RowVec<QR>::T;
  const int grp = t % S::GROUPS, slice = t / S::GROUPS;
  float acc[QR][RT];
#pragma unroll
  for (int q = 0; q < QR; ++q)
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[q][r] = 0.f;
  const int n_chunks = (n_pad + JC - 1) / JC;
  for (int c = 0; c < n_chunks; ++c) {
    const int j0 = ((c + (int)blockIdx.x) % n_chunks) * JC;
    const int len = min(JC, n_pad - j0);  // a multiple of 128
    sync();  // scratch free; earlier spin writes visible
    for (int e = t; e < len * RT; e += NT) {
      const int rr = e % RT;
      scratch[e] = (r0 + rr < R) ? spins[(size_t)(j0 + e / RT) * R + r0 + rr]
                                 : 0.f;
    }
    sync();
    const int per = len / S::SLICES;
    const int jb = slice * per;
    const V* jp =
        reinterpret_cast<const V*>(J + (size_t)(j0 + jb) * n_pad + i0) + grp;
    const int rot = ((int)blockIdx.x * 16) % per;
    const size_t stride = (size_t)n_pad / QR;
    const float* sp = scratch + jb * RT;
#pragma unroll (UNROLL)
    for (int jn = 0; jn < per; ++jn) {
      int jj = jn + rot;
      if (jj >= per) jj -= per;
      float av[QR];
      unpack(__ldg(jp + jj * stride), av);
      const float4* s4 = reinterpret_cast<const float4*>(sp + jj * RT);
      float4 sv[RT / 4];
#pragma unroll
      for (int r4 = 0; r4 < RT / 4; ++r4) sv[r4] = s4[r4];
#pragma unroll
      for (int q = 0; q < QR; ++q) {
#pragma unroll
        for (int r4 = 0; r4 < RT / 4; ++r4) {
          acc[q][4 * r4 + 0] = fmaf(av[q], sv[r4].x, acc[q][4 * r4 + 0]);
          acc[q][4 * r4 + 1] = fmaf(av[q], sv[r4].y, acc[q][4 * r4 + 1]);
          acc[q][4 * r4 + 2] = fmaf(av[q], sv[r4].z, acc[q][4 * r4 + 2]);
          acc[q][4 * r4 + 3] = fmaf(av[q], sv[r4].w, acc[q][4 * r4 + 3]);
        }
      }
    }
  }
  sync();  // every slice is done with the spin chunk
#pragma unroll
  for (int q = 0; q < QR; ++q)
#pragma unroll
    for (int r = 0; r < RT; ++r)
      scratch[(slice * B + QR * grp + q) * RT + r] = acc[q][r];
  sync();
}

// Field of block row k, tile column r: the slices in order, then h.
template <int B, int RT, int NT>
__device__ __forceinline__ float block_field(const float* part, int k, int r,
                                             float hv) {
  float v = 0.f;
#pragma unroll
  for (int sl = 0; sl < FieldShape<B, RT, NT>::SLICES; ++sl)
    v += part[(sl * B + k) * RT + r];
  return v + hv;
}

// J[row0 + i, i0 .. i0 + B) for i = 0..ROWS-1 into dst[ROWS][B] (by
// symmetry, the block's columns row0..row0+ROWS-1), by the NT threads of a
// group; t is the thread's index in it.
template <int B, int ROWS, int NT>
__device__ __forceinline__ void stage_j_rows(const float* __restrict__ J,
                                             int n_pad, int row0, int i0,
                                             int t, float* dst) {
  const float4* src = reinterpret_cast<const float4*>(
      J + (size_t)row0 * n_pad + i0);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int e = t; e < ROWS * B / 4; e += NT) {
    const int i = e / (B / 4), c4 = e % (B / 4);
    d[e] = __ldg(src + (size_t)i * (n_pad / 4) + c4);
  }
}

// Spin and threshold of replica col at spin `row`. Without u the uniform is
// Philox4x32-10 keyed by the sweep seed (k0, k1) with counter (row, col), so
// the stream depends on neither the tile nor the block size; a row with
// mask == 0 gets u = 2, whose threshold is -inf. A dead column (col >= R)
// gets s = 1 and th = -inf and never flips: s * f < -inf is false.
template <int RULE>  // RULE 0: metropolis, 1: glauber
__device__ __forceinline__ void spin_state(const float* spins,
                                           const float* __restrict__ u,
                                           const float* __restrict__ mask,
                                           int row, int col, bool live, int R,
                                           uint32_t k0, uint32_t k1, float nib,
                                           float& s, float& th) {
  if (!live) {
    s = 1.f;
    th = -INFINITY;
    return;
  }
  s = spins[(size_t)row * R + col];
  float uu = u ? u[(size_t)row * R + col]
               : philox_uniform((uint32_t)row, (uint32_t)col, k0, k1);
  if (!(mask[row] > 0.f)) uu = 2.f;
  th = threshold<RULE>(uu, nib);
}

// The B dependent decisions of the row-block at i0 for one warp's NC
// chains (see the top of this file). For each group of 32 rows the NT
// threads of the caller's group stage J's rows in jst[32][B] between two
// barriers. With ds_out, the owner lane also writes the ds of chain c at
// block row k to ds_out[k * ds_stride + c].
template <int B, int NC, int NT, int UNROLL, class Sync>
__device__ __forceinline__ void decide_block(
    const float* __restrict__ J, int n_pad, int i0, int t, float* jst,
    float (&f)[NC][B / 32], float (&s)[NC][B / 32],
    const float (&th)[NC][B / 32], float (&de_acc)[NC], int (&cnt_acc)[NC],
    float* ds_out, int ds_stride, Sync sync) {
  constexpr int FPL = B / 32;  // block rows per lane
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t0 = 0; t0 < FPL; ++t0) {
    sync();  // jst free
    stage_j_rows<B, 32, NT>(J, n_pad, i0 + 32 * t0, i0, t, jst);
    sync();
#pragma unroll (UNROLL)
    for (int src = 0; src < 32; ++src) {
      float dsb[NC];
      bool any = false;
#pragma unroll
      for (int c = 0; c < NC; ++c) {  // the interleave
        const float sv = s[c][t0], fv = f[c][t0];
        const bool accept = sv * fv < th[c][t0];
        const float ds = accept ? -2.f * sv : 0.f;
        dsb[c] = __shfl_sync(kFull, ds, src);
        if (lane == src) {
          s[c][t0] = sv + ds;
          de_acc[c] -= ds * fv;
          cnt_acc[c] += accept ? 1 : 0;
          if (ds_out) ds_out[(32 * t0 + src) * ds_stride + c] = ds;
        }
        any |= dsb[c] != 0.f;
      }
      if (any) {  // uniform in the warp; one read of J's row serves all
        const float* jrow = jst + src * B + lane;
        float jv[FPL];
#pragma unroll
        for (int k = 0; k < FPL; ++k) jv[k] = jrow[32 * k];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (dsb[c] != 0.f) {
#pragma unroll
            for (int k = 0; k < FPL; ++k) f[c][k] = fmaf(jv[k], dsb[c], f[c][k]);
          }
        }
      }
    }
  }
}

// Sums each chain's dE and count over the warp; lane 0 stores the live ones.
template <int NC>
__device__ __forceinline__ void store_totals(float (&de_acc)[NC],
                                             int (&cnt_acc)[NC],
                                             const int (&col)[NC], int R,
                                             float* __restrict__ de_out,
                                             int* __restrict__ cnt_out) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      de_acc[c] += __shfl_xor_sync(kFull, de_acc[c], off);
      cnt_acc[c] += __shfl_xor_sync(kFull, cnt_acc[c], off);
    }
    if ((threadIdx.x & 31) == 0 && col[c] < R) {
      de_out[col[c]] = de_acc[c];
      cnt_out[col[c]] = cnt_acc[c];
    }
  }
}

// K1 (NC = 1) and K6 (NC = 2, 4): one thread block of 8 warps owns a tile of
// RT = 8 * NC replica columns for the whole sweep (warp w owns the columns
// r0 + w*NC + c) and loops over the row-blocks: (1) the tile's B x RT block
// fields, (2) the B dependent decisions, (3) the block's spins stored.
template <int B, int RULE, int NC, int FIELD_UNROLL, int DECIDE_UNROLL>
__global__ void __launch_bounds__(256, 1)
tile_sweep_kernel(const float* __restrict__ J, const float* __restrict__ h,
                  const float* __restrict__ mask, float* spins,
                  const float* __restrict__ beta, const float* __restrict__ u,
                  uint32_t k0, uint32_t k1,
                  const unsigned long long* __restrict__ seed_ptr,
                  float* __restrict__ de_out, int* __restrict__ cnt_out,
                  int n_pad, int R) {
  constexpr int THREADS = 256;
  device_seed(seed_ptr, k0, k1);
  constexpr int RT = 8 * NC;
  constexpr int FPL = B / 32;
  static_assert(32 * B <= kScratch, "J rows fit the scratch");
  __shared__ __align__(16) float scratch[kScratch];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * RT;
  int col[NC];
  bool live[NC];
  float nib[NC], de_acc[NC];
  int cnt_acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    col[c] = r0 + warp * NC + c;
    live[c] = col[c] < R;
    nib[c] = live[c] ? -0.5f / beta[col[c]] : 0.f;
    de_acc[c] = 0.f;
    cnt_acc[c] = 0;
  }

  for (int i0 = 0; i0 < n_pad; i0 += B) {
    // ---- (1) block fields --------------------------------------------
    field_partials<B, RT, THREADS, FIELD_UNROLL>(J, spins, n_pad, R, r0, i0,
                                                 tid, scratch, BlockSync());
    // ---- (2) B dependent decisions, NC chains per warp ---------------
    float f[NC][FPL], s[NC][FPL], th[NC][FPL];
    if constexpr (NC == 1) {
      // K1: all threads add the slices into a padded [B][9] array, which
      // the lanes then read without bank conflicts
      __shared__ float h_blk[B][RT + 1];
      for (int k = tid; k < B; k += THREADS) {
        const float hv = h[i0 + k];
#pragma unroll
        for (int r = 0; r < RT; ++r)
          h_blk[k][r] = block_field<B, RT, THREADS>(scratch, k, r, hv);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < FPL; ++k) f[0][k] = h_blk[lane + 32 * k][warp];
    } else {
#pragma unroll
      for (int k = 0; k < FPL; ++k) {
        const float hv = h[i0 + lane + 32 * k];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          f[c][k] = block_field<B, RT, THREADS>(scratch, lane + 32 * k,
                                                warp * NC + c, hv);
      }
    }
#pragma unroll
    for (int k = 0; k < FPL; ++k)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        spin_state<RULE>(spins, u, mask, i0 + lane + 32 * k, col[c], live[c],
                         R, k0, k1, nib[c], s[c][k], th[c][k]);
    decide_block<B, NC, THREADS, DECIDE_UNROLL>(
        J, n_pad, i0, tid, scratch, f, s, th, de_acc, cnt_acc, nullptr, 0,
        BlockSync());
    // ---- (3) the block's new spins -----------------------------------
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (live[c]) {
#pragma unroll
        for (int k = 0; k < FPL; ++k)
          spins[(size_t)(i0 + lane + 32 * k) * R + col[c]] = s[c][k];
      }
    }
  }
  store_totals<NC>(de_acc, cnt_acc, col, R, de_out, cnt_out);
}

}  // namespace sgt
