// The cluster design of the dense sweep: K1's (metropolis_sweep.cu:
// cluster_sweep_kernel), shared by K1 and the cluster kernels of its
// variants K5 (metropolis_pipelined.cu) and K7 (metropolis_folded.cu): the
// small pieces, the field phase, the reduction, the stores and the launch.
//
// A replica tile of kRT = 72 columns is shared by a thread-block cluster of
// kCS = 8 blocks; block c keeps spin rows [c Np/8, (c+1) Np/8) of the tile
// in its shared memory for the whole sweep, as bf16 in [column][row] order
// (spin_stride_words), and decides kCPB = 9 of the tile's columns. For a
// row-block of B rows at i0, warps 0..7 of every block multiply
// J[i0:i0+B, its rows] with its spin rows for all 72 columns on the tensor
// cores (SGT_CLUSTER_FIELD_PARTIALS: mma.sync.m16n8k16 on an exact split of
// float32 J into 1 or 3 bf16 planes, see metropolis_sweep.cu) and leave the
// partial fields in shared memory as part[d][k][9]; after a cluster barrier
// block d adds the 8 blocks' partials of its own 9 columns in block order
// (cluster_reduce_fields: deterministic) and adds h. What the blocks then
// do with the fields is the kernel's own.
//
// Barriers. __syncthreads() is bar.sync 0, which is barrier.sync.aligned:
// every thread of the block must reach the same instruction. Where a kernel
// splits its warps into roles with code paths of their own (K5, K7), the
// roles meet at block_barrier() below, barrier.sync 0 without .aligned,
// which threads may reach from different instructions, and at cg's
// cluster.sync(), which lowers to barrier.cluster.arrive and
// barrier.cluster.wait without .aligned (checked in the PTX of CUDA 12.8).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_sweep.cuh"

namespace sgt {

namespace cg = cooperative_groups;

constexpr int kCS = 8;               // thread blocks per cluster
constexpr int kCPB = 9;              // columns a block decides
constexpr int kRT = kCS * kCPB;      // 72 replica columns per cluster
constexpr int kNTILE = kRT / 8;      // MMA n-tiles of 8 columns
constexpr int kMmaWarps = 8;         // warps 0..7 multiply

// 32-bit words between two columns of a block's spin slice of `rpb` rows:
// rpb / 2 words of bf16 pairs, padded to 8 mod 32 so that the 64-bit
// B-fragment loads of a half-warp (4 columns x 4 word pairs) hit 32
// different banks.
__host__ __device__ constexpr int spin_stride_words(int rpb) {
  return rpb / 2 + (40 - (rpb / 2) % 32) % 32;
}

// Bytes of a block's spin slice of the tile at this n_pad.
__host__ __device__ constexpr size_t cluster_spin_bytes(int n_pad) {
  return (size_t)kRT * spin_stride_words(n_pad / kCS) * 4;
}

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);  // x low, y high
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_low(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_high(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// bf16 planes of the pair (x, y): hi + mid + lo == the float32 values.
template <int PLANES>
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(x, y);
  if (PLANES == 3) {
    const float rx = x - bf16_low(hi), ry = y - bf16_high(hi);
    mid = pack_bf16(rx, ry);
    lo = pack_bf16(rx - bf16_low(mid), ry - bf16_high(mid));
  }
}

// The A fragments of one 16 x 16 tile from the float4s of rows g (top) and
// g + 8 (bot), k slots permuted as the B fragments expect (see
// metropolis_sweep.cu).
template <int PLANES>
__device__ __forceinline__ void split_tile(const float4& top, const float4& bot,
                                           uint32_t (&ah)[4], uint32_t (&am)[4],
                                           uint32_t (&al)[4]) {
  split_pair<PLANES>(top.x, top.y, ah[0], am[0], al[0]);
  split_pair<PLANES>(bot.x, bot.y, ah[1], am[1], al[1]);
  split_pair<PLANES>(top.z, top.w, ah[2], am[2], al[2]);
  split_pair<PLANES>(bot.z, bot.w, ah[3], am[3], al[3]);
}

// d += A (16 x 16, row) * B (16 x 8, col), bf16 in, float32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint2& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// d = the planes' products of one k-step over N n-tiles, chained in the
// tensor core from 0 (lo, mid, hi; each plane over all n-tiles before the
// next, so no MMA waits for the one before it). Exact: every product is.
template <int PLANES, int N>
__device__ __forceinline__ void plane_products(float (&d)[N][4],
                                               const uint32_t (&ah)[4],
                                               const uint32_t (&am)[4],
                                               const uint32_t (&al)[4],
                                               const uint2 (&bf)[N]) {
#pragma unroll
  for (int nt = 0; nt < N; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) d[nt][q] = 0.f;
  if (PLANES == 3) {
#pragma unroll
    for (int nt = 0; nt < N; ++nt) mma_bf16(d[nt], al, bf[nt]);
#pragma unroll
    for (int nt = 0; nt < N; ++nt) mma_bf16(d[nt], am, bf[nt]);
  }
#pragma unroll
  for (int nt = 0; nt < N; ++nt) mma_bf16(d[nt], ah, bf[nt]);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// J[row0 + i, col0 .. col0 + W) for i = 0..ROWS-1 into dst[ROWS][STRIDE]
// with cp.async by the NT threads of a group (t: the thread's index in it),
// as one commit group per thread.
template <int W, int ROWS, int NT, int STRIDE = W>
__device__ __forceinline__ void stage_rows_async(const float* __restrict__ J,
                                                 int n_pad, int row0, int col0,
                                                 int t, float* dst) {
  for (int e = t; e < ROWS * W / 4; e += NT) {
    float* d = STRIDE == W ? dst + 4 * e
                           : dst + (e / (W / 4)) * STRIDE + 4 * (e % (W / 4));
    cp_async16(d, J + (size_t)(row0 + e / (W / 4)) * n_pad + col0 +
                      4 * (e % (W / 4)));
  }
  cp_async_commit();
}

// One batch of A operands: for each of KB k-steps from `ks` and each of the
// warp's MT MMA tiles, the float4s of J at rows g and g + 8 (zeros past the
// block's last k-step).
template <int KB, int MT>
__device__ __forceinline__ void load_batch(float4 (&dst)[KB][MT][2],
                                           const float* __restrict__ jbase,
                                           int n_pad, int ks, int nks) {
#pragma unroll
  for (int ku = 0; ku < KB; ++ku)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        dst[ku][mt][hf] =
            ks + ku < nks
                ? __ldg(reinterpret_cast<const float4*>(
                      jbase + (size_t)(16 * mt + 8 * hf) * n_pad +
                      16 * (ks + ku)))
                : make_float4(0.f, 0.f, 0.f, 0.f);
}

// This block's rows of the tile at r0 into its shared memory, [column][row]
// bf16 (dead columns 0), by NT threads.
template <int NT>
__device__ __forceinline__ void load_tile_spins(const float* spins,
                                                __nv_bfloat16* spin_h, int sw,
                                                int rank, int rpb, int r0,
                                                int R, int tid) {
  for (int e = tid; e < rpb * kRT; e += NT) {
    const int c = e % kRT, lr = e / kRT;
    const float v =
        r0 + c < R ? spins[(size_t)(rank * rpb + lr) * R + r0 + c] : 0.f;
    spin_h[c * (2 * sw) + lr] = __float2bfloat16_rn(v);
  }
}

// J[row0 : row0 + B, this block's columns] into L2, by NT threads.
template <int B, int NT>
__device__ __forceinline__ void prefetch_rows_l2(const float* __restrict__ J,
                                                 int n_pad, int row0, int rank,
                                                 int rpb, int tid) {
  const int segs = (rpb + 31) / 32;  // 128-byte lines per row
  for (int e = tid; e < B * segs; e += NT) {
    const float* p = J + (size_t)(row0 + e / segs) * n_pad + rank * rpb +
                     32 * (e % segs);
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
  }
}

// Partial block fields of the cluster's 72 columns for the row-block at i0,
// over this block's rpb spin rows, by one of the 8 multiplying warps:
// part[d][k][kCPB] for the columns block d decides, block row k. g and t
// are the lane's MMA group and thread in group (lane >> 2, lane & 3) and
// nks = rpb / 16, all three declared by the kernel outside its row-block
// loop. A macro, expanded in the kernel's own code: at its cap of 168
// registers a thread, ptxas's allocation of K1 follows the order of the
// kernel's statements, and through a __forceinline__ function of the same
// text (or with g and t declared later) K1 measured 1-2% slower and its
// machine code differed; expanded here it is K1's inline code, instruction
// for instruction (PERF.md section 6, benchmarks/sass_diff.py).
//
// k-steps (16 spin rows) per batch of loads, fetched one batch ahead: 8
// float4s per thread in flight (2 k-steps at B = 128 measured 16% slower),
// but 4 at B = 256 with three planes, which otherwise spills its 168
// registers (920 us/sweep against 802). Each k-step's exact sum of plane
// products goes into the running field with a float32 add; chaining more
// k-steps in the tensor core measured slower (registers).
#define SGT_CLUSTER_FIELD_PARTIALS(B, PLANES, J, n_pad, i0, rank, rpb, warp,  \
                                   g_, t_, nks_, spin_w, sw, part)            \
  do {                                                                        \
    constexpr int MT_ = (B) / 128;                                            \
    constexpr int KB_ = ((B) == 256 && (PLANES) == 3) ? 1 : 4 / MT_;          \
    float acc_[MT_][sgt::kNTILE][4];                                          \
    _Pragma("unroll") for (int mt = 0; mt < MT_; ++mt)                        \
    _Pragma("unroll") for (int nt = 0; nt < sgt::kNTILE; ++nt)                \
    _Pragma("unroll") for (int q = 0; q < 4; ++q) acc_[mt][nt][q] = 0.f;      \
    const float* jbase_ = (J) + (size_t)((i0) + 16 * MT_ * (warp) + g_) *     \
                          (n_pad) + (rank) * (rpb) + 4 * t_;                  \
    float4 cur_[KB_][MT_][2], nxt_[KB_][MT_][2];                              \
    sgt::load_batch<KB_, MT_>(cur_, jbase_, (n_pad), 0, nks_);                \
    for (int ks = 0; ks < nks_; ks += KB_) {                                  \
      sgt::load_batch<KB_, MT_>(nxt_, jbase_, (n_pad), ks + KB_, nks_);       \
      _Pragma("unroll") for (int ku = 0; ku < KB_; ++ku) {                    \
        if (ks + ku < nks_) {                                                 \
          uint2 bf_[sgt::kNTILE];                                             \
          _Pragma("unroll") for (int nt = 0; nt < sgt::kNTILE; ++nt)          \
            bf_[nt] = *reinterpret_cast<const uint2*>(                        \
                (spin_w) + (8 * nt + g_) * (sw) + 8 * (ks + ku) + 2 * t_);    \
          _Pragma("unroll") for (int mt = 0; mt < MT_; ++mt) {                \
            const float4 top_ = cur_[ku][mt][0], bot_ = cur_[ku][mt][1];      \
            uint32_t ah_[4], am_[4], al_[4];                                  \
            sgt::split_pair<PLANES>(top_.x, top_.y, ah_[0], am_[0], al_[0]);  \
            sgt::split_pair<PLANES>(bot_.x, bot_.y, ah_[1], am_[1], al_[1]);  \
            sgt::split_pair<PLANES>(top_.z, top_.w, ah_[2], am_[2], al_[2]);  \
            sgt::split_pair<PLANES>(bot_.z, bot_.w, ah_[3], am_[3], al_[3]);  \
            float d_[sgt::kNTILE][4];                                         \
            _Pragma("unroll") for (int nt = 0; nt < sgt::kNTILE; ++nt)        \
            _Pragma("unroll") for (int q = 0; q < 4; ++q) d_[nt][q] = 0.f;    \
            if ((PLANES) == 3) {                                              \
              _Pragma("unroll") for (int nt = 0; nt < sgt::kNTILE; ++nt)      \
                sgt::mma_bf16(d_[nt], al_, bf_[nt]);                          \
              _Pragma("unroll") for (int nt = 0; nt < sgt::kNTILE; ++nt)      \
                sgt::mma_bf16(d_[nt], am_, bf_[nt]);                          \
            }                                                                 \
            _Pragma("unroll") for (int nt = 0; nt < sgt::kNTILE; ++nt)        \
              sgt::mma_bf16(d_[nt], ah_, bf_[nt]);                            \
            _Pragma("unroll") for (int nt = 0; nt < sgt::kNTILE; ++nt)        \
            _Pragma("unroll") for (int q = 0; q < 4; ++q)                     \
              acc_[mt][nt][q] += d_[nt][q];                                   \
          }                                                                   \
        }                                                                     \
      }                                                                       \
      _Pragma("unroll") for (int ku = 0; ku < KB_; ++ku)                      \
      _Pragma("unroll") for (int mt = 0; mt < MT_; ++mt)                      \
      _Pragma("unroll") for (int hf = 0; hf < 2; ++hf)                        \
        cur_[ku][mt][hf] = nxt_[ku][mt][hf];                                  \
    }                                                                         \
    _Pragma("unroll") for (int mt = 0; mt < MT_; ++mt)                        \
    _Pragma("unroll") for (int nt = 0; nt < sgt::kNTILE; ++nt)                \
    _Pragma("unroll") for (int q = 0; q < 4; ++q) {                           \
      const int row_ = 16 * (MT_ * (warp) + mt) + g_ + 8 * (q >> 1);         \
      const int ct_ = 8 * nt + 2 * t_ + (q & 1);                             \
      (part)[((ct_ / sgt::kCPB) * (B) + row_) * sgt::kCPB + ct_ % sgt::kCPB] = \
          acc_[mt][nt][q];                                                    \
    }                                                                         \
  } while (0)

// This block's columns of the row-block at i0: the 8 blocks' partials in
// block order, + h, into h_blk[B][kCPB], by NT threads (all loads in flight).
template <int B, int NT>
__device__ __forceinline__ void cluster_reduce_fields(
    cg::cluster_group& cluster, float* part, int rank,
    const float* __restrict__ h, int i0, int tid, float* h_blk) {
  constexpr int E = B * kCPB;
#pragma unroll
  for (int it = 0; it < (E + NT - 1) / NT; ++it) {
    const int e = tid + it * NT;
    if (E % NT == 0 || e < E) {
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < kCS; ++c)
        v += cluster.map_shared_rank(part, c)[rank * B * kCPB + e];
      h_blk[e] = v + h[i0 + e / kCPB];
    }
  }
}

// The new spin of tile column `own` at `row` into the shared memory of the
// block that keeps that row.
__device__ __forceinline__ void store_owner_spin(cg::cluster_group& cluster,
                                                 __nv_bfloat16* spin_h, int sw,
                                                 int rpb, int own, int row,
                                                 float s) {
  const int owner = row / rpb;
  __nv_bfloat16* dst = cluster.map_shared_rank(spin_h, owner) +
                       own * (2 * sw) + (row - owner * rpb);
  *dst = __float2bfloat16_rn(s);
}

// Every thread of the block, from any code path: barrier 0, not aligned.
__device__ __forceinline__ void block_barrier() { __barrier_sync(0); }

// Launches `kernel` on clusters of kCS blocks along x (grid: ceil(R / 72)
// clusters by `problems`), or with `clusters` only asks how many of them
// the card holds at once. `allowed` is the caller's static for allow_smem.
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, int R, int problems, int threads,
                            size_t smem, size_t& allowed, cudaStream_t stream,
                            int* clusters, Args... args) {
  const cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((R + kRT - 1) / kRT) * kCS, problems);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace sgt
