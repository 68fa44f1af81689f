// K7 on Hopper: K1's sweep with immediate corrections inside micro-blocks
// of 32 rows and one delayed update per micro-block.
//
// Replaces the Pallas TPU kernel spinglass_tpu/kernels/metropolis_pallas.py
// (_make_kernel_folded, built by _build_call, driven by
// FusedSweep(folded=True)). Makes exactly the decisions of a sequential
// sweep over spins 0..Np-1, per replica:
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
// What bounds it on the H100 (Np = 4096, R = 1024): the work of K1, 2 Np^2 R
// = 3.44e10 FLOP per plane of J, 104 us on the bf16 tensor cores with three
// planes (35 us with one); J once and the spins read and written are 30 us
// at 3.35 TB/s. K1's decisions (~23% of its time) are a chain of compare ->
// shuffle -> FMA, ~80 clocks, per spin; the micro-block's chain is compare
// -> select -> FMA in one thread's registers.
//
// Design: folded_cluster_kernel, on K1's cluster (cluster_sweep.cuh): a
// 72-column replica tile per cluster of 8 blocks of 9 warps, each block
// keeping Np/8 spin rows as bf16, the block fields from mma.sync on J's
// exact bf16 planes by warps 0..7, split-K over the cluster and reduced in
// block order into the block's fields [B][9]. Then, per micro-block:
//   * one thread per column (lanes 0..8 of warp 8: the TPU folds replicas
//     onto its vector lanes, here lane = replica) keeps the micro-block's
//     32 fields in registers and decides row by row with no shuffle,
//     correcting its own later rows with J's diagonal micro-block, which
//     every lane reads at one shared address (a broadcast); the block's
//     diagonal micro-blocks are staged at the start of the row-block by
//     cp.async. Spins and thresholds (Philox, drawn by all 9 warps while
//     the fields are computed, one column per warp) wait in shared memory.
//   * warps 0..7 then add J[rows after the micro-block, micro-block] @ ds to
//     the block's fields on the tensor cores (mma.sync.m16n8k16, J's planes
//     split in registers from float4s fetched while the thread decides, ds
//     in {0, +-2} exact in bf16 as the B operand, 9 columns padded to 16).
// The two roles take code paths of their own through the micro-blocks and
// meet there at the non-aligned block_barrier (cluster_sweep.cuh); every
// other barrier is reached by all threads at one instruction.
// A row-block ends as K1's: the new spins to the owners' shared memory and
// out, two cluster barriers. Shared memory: K1's spins and partials, the
// diagonal micro-blocks (32 B floats), fields, spins and thresholds [B][9]
// and the ds operand, so the cluster kernel takes n_pad up to 8832 at
// B = 128 and 5120 at B = 256 (metropolis_cuda.folded_tile).
//
// Beyond that the wrapper asks for cluster = 1: the first version's
// one-block float32 kernel, folded_kernel below (lane = replica over a tile
// of 32 columns per thread block; the block fields by dense_sweep.cuh's
// field phase, which streams all of J per tile from L2; one warp decides
// while 7 wait; the delayed update as float32 FMAs by 8 warps).
//
// Randomness and masks as in K1: Philox4x32-10, counter (spin, replica),
// unless u is given; rows with mask == 0 get u = 2; columns beyond R never
// flip and are never stored. Precision: every product is exact and every
// sum float32, in an order fixed per launch shape; the delayed update sums
// in the tensor core's order where K1 corrects flip by flip, so on Gaussian
// couplings the fields differ from K1's in their last bits (on +-J with h
// on a dyadic grid every sum is exact: bitwise equal to K1 and the twin).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_sweep.cuh"
#include "dense_sweep.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int C = 32;  // micro-block rows

// ---- the cluster kernel ------------------------------------------------
constexpr int CS = sgt::kCS;
constexpr int CPB = sgt::kCPB;
constexpr int CRT = sgt::kRT;          // 72 replica columns
constexpr int CL_THREADS = 32 * CPB;   // 9 warps: 0..7 multiply, 8 decides
constexpr int DECIDER = sgt::kMmaWarps;
constexpr int DSW = 20;   // 32-bit words per column of the ds operand: 16
                          // bf16 pairs, padded against bank conflicts
constexpr int DS_COLS = 16;  // the delayed product's two n-tiles

__host__ __device__ constexpr size_t folded_smem_bytes(int n_pad, int B) {
  return sgt::cluster_spin_bytes(n_pad)  // spins, bf16
         + (size_t)CRT * B * 4           // part[CS][B][CPB]
         + (size_t)C * B * 4             // diagonal micro-blocks [B/C][C][C]
         + (size_t)3 * B * CPB * 4       // fields, spins, thresholds [B][CPB]
         + (size_t)DS_COLS * DSW * 4;    // ds [16][DSW] bf16 pairs
}

// The block's diagonal micro-blocks J[i0 + lo + i, i0 + lo + k] into
// dst[B / C][C][C] with cp.async, by all threads.
template <int B>
__device__ __forceinline__ void stage_micro_blocks(const float* __restrict__ J,
                                                   int n_pad, int i0, int tid,
                                                   float* dst) {
  for (int e = tid; e < B * C / 4; e += CL_THREADS) {
    const int m = e / (C * C / 4), i = (e / (C / 4)) % C, q = e % (C / 4);
    sgt::cp_async16(dst + 4 * e,
                    J + (size_t)(i0 + C * m + i) * n_pad + i0 + C * m + 4 * q);
  }
  sgt::cp_async_commit();
}

// The C dependent decisions of micro-block m for column `lane` (< CPB):
// fields, spins and thresholds in registers, no shuffle; an accepted flip
// corrects only the micro-block's later rows, with J's row i of the
// micro-block read as float4 broadcasts. The new spins go to s_blk, ds as
// bf16 pairs (exact: 0, +-2) to the column's words of ds_w.
__device__ __forceinline__ void decide_micro(int m, int lane, const float* jmb,
                                             const float* h_blk, float* s_blk,
                                             const float* th_blk,
                                             uint32_t* ds_w, float& de_acc,
                                             int& cnt_acc) {
  const int lo = C * m;
  float f[C], s[C], th[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    f[i] = h_blk[(lo + i) * CPB + lane];
    s[i] = s_blk[(lo + i) * CPB + lane];
    th[i] = th_blk[(lo + i) * CPB + lane];
  }
  const float4* jr = reinterpret_cast<const float4*>(jmb + m * C * C);
  float ds_prev = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const float sv = s[i];
    const bool accept = sv * f[i] < th[i];
    const float ds = accept ? -2.f * sv : 0.f;
    s_blk[(lo + i) * CPB + lane] = sv + ds;
    de_acc -= ds * f[i];
    cnt_acc += accept ? 1 : 0;
#pragma unroll
    for (int q = (i + 1) / 4; q < C / 4; ++q) {
      const float4 jv = jr[i * (C / 4) + q];  // J[lo + i, lo + 4q .. + 3]
      if (4 * q + 0 > i) f[4 * q + 0] = fmaf(jv.x, ds, f[4 * q + 0]);
      if (4 * q + 1 > i) f[4 * q + 1] = fmaf(jv.y, ds, f[4 * q + 1]);
      if (4 * q + 2 > i) f[4 * q + 2] = fmaf(jv.z, ds, f[4 * q + 2]);
      if (4 * q + 3 > i) f[4 * q + 3] = fmaf(jv.w, ds, f[4 * q + 3]);
    }
    if (i & 1) ds_w[lane * DSW + i / 2] = sgt::pack_bf16(ds_prev, ds);
    ds_prev = ds;
  }
}

// The A operands of the delayed update after micro-block m: for each of the
// warp's MT 16-row tiles and both k-steps of the micro-block, the float4s
// of J at rows g and g + 8, columns lo + 16 ks + 4t .. + 3 (tiles that end
// before the micro-block's end are not read).
template <int B>
__device__ __forceinline__ void load_delayed(float4 (&a)[B / 128][2][2],
                                             const float* __restrict__ J,
                                             int n_pad, int i0, int lo,
                                             int warp, int lane) {
  constexpr int MT = B / 128;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row0 = 16 * (MT * warp + mt);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        a[mt][ks][hf] =
            row0 >= lo + C
                ? __ldg(reinterpret_cast<const float4*>(
                      J + (size_t)(i0 + row0 + g + 8 * hf) * n_pad + i0 + lo +
                      16 * ks + 4 * t))
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// h_blk[k][c] += sum_i J[i0 + k, i0 + lo + i] ds_i[c] for the rows k of the
// warp's tiles after the micro-block: per k-step the planes' exact products
// chained in the tensor core, the two k-steps' sums added in float32.
template <int B, int PLANES>
__device__ __forceinline__ void delayed_update(const float4 (&a)[B / 128][2][2],
                                               int lo, int warp, int lane,
                                               const uint32_t* ds_w,
                                               float* h_blk) {
  constexpr int MT = B / 128;
  const int g = lane >> 2, t = lane & 3;
  uint2 bf[2][2];  // [k-step][n-tile]: ds of rows 16 ks + 4t .. + 3
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      bf[ks][nt] = *reinterpret_cast<const uint2*>(
          ds_w + (8 * nt + g) * DSW + 8 * ks + 2 * t);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row0 = 16 * (MT * warp + mt);
    if (row0 < lo + C) continue;
    float acc[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t ah[4], am[4], al[4];
      sgt::split_tile<PLANES>(a[mt][ks][0], a[mt][ks][1], ah, am, al);
      float d[2][4];
      sgt::plane_products<PLANES, 2>(d, ah, am, al, bf[ks]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[nt][q] = ks == 0 ? d[nt][q] : acc[nt][q] + d[nt][q];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = row0 + g + 8 * (q >> 1);
        const int ct = 8 * nt + 2 * t + (q & 1);
        if (ct < CPB) h_blk[row * CPB + ct] += acc[nt][q];
      }
  }
}

template <int B, int RULE, int PLANES>
__global__ void __launch_bounds__(CL_THREADS, 1)
folded_cluster_kernel(const float* __restrict__ J, const float* __restrict__ h,
                      const float* __restrict__ mask, float* spins,
                      const float* __restrict__ beta,
                      const float* __restrict__ u, uint32_t k0, uint32_t k1,
                      const unsigned long long* __restrict__ seed_ptr,
                      float* __restrict__ de_out, int* __restrict__ cnt_out,
                      int n_pad, int R) {
  sgt::device_seed(seed_ptr, k0, k1);
  constexpr int FPL = B / 32;
  constexpr int NM = B / C;  // micro-blocks per row-block
  extern __shared__ __align__(16) unsigned char cluster_smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = (int)blockIdx.x / CS, n_tiles = (int)gridDim.x / CS;
  const int rpb = n_pad / CS;  // spin rows this block keeps
  const int sw = sgt::spin_stride_words(rpb);
  uint32_t* spin_w = reinterpret_cast<uint32_t*>(cluster_smem);
  __nv_bfloat16* spin_h = reinterpret_cast<__nv_bfloat16*>(cluster_smem);
  float* part = reinterpret_cast<float*>(cluster_smem + (size_t)CRT * sw * 4);
  float* jmb = part + CRT * B;         // [NM][C][C]
  float* h_blk = jmb + C * B;          // [B][CPB]
  float* s_blk = h_blk + B * CPB;      // [B][CPB]
  float* th_blk = s_blk + B * CPB;     // [B][CPB]
  uint32_t* ds_w = reinterpret_cast<uint32_t*>(th_blk + B * CPB);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // MMA group and thread in group
  const int r0 = tile * CRT;
  const int own = rank * CPB + warp;  // the column this warp draws for
  const bool live = r0 + own < R;
  const float nib = live ? -0.5f / beta[r0 + own] : 0.f;
  float de_acc = 0.f;
  int cnt_acc = 0;

  for (int e = tid; e < DS_COLS * DSW; e += CL_THREADS) ds_w[e] = 0u;
  sgt::load_tile_spins<CL_THREADS>(spins, spin_h, sw, rank, rpb, r0, R, tid);
  __syncthreads();

  const int nks = rpb / 16;
  for (int i0 = 0; i0 < n_pad; i0 += B) {
    // ---- (0) ahead of time: the diagonal micro-blocks, and (one cluster
    // in turn) the next row-block's slice of J into L2
    stage_micro_blocks<B>(J, n_pad, i0, tid, jmb);
    if (i0 + B < n_pad && tile == (i0 / B) % n_tiles)
      sgt::prefetch_rows_l2<B, CL_THREADS>(J, n_pad, i0 + B, rank, rpb, tid);

    // ---- (1) partial block fields of the cluster's 72 columns ----------
    if (warp < sgt::kMmaWarps)
      SGT_CLUSTER_FIELD_PARTIALS(B, PLANES, J, n_pad, i0, rank, rpb, warp,
                                 g, t, nks, spin_w, sw, part);
    // spins and thresholds of this warp's column, while others multiply
#pragma unroll
    for (int k = 0; k < FPL; ++k) {
      const int row = lane + 32 * k;
      sgt::spin_state<RULE>(spins, u, mask, i0 + row, r0 + own, live, R, k0,
                            k1, nib, s_blk[row * CPB + warp],
                            th_blk[row * CPB + warp]);
    }
    cluster.sync();  // every block's partials are in place

    // ---- (2) this block's columns: the partials in block order, + h ----
    sgt::cluster_reduce_fields<B, CL_THREADS>(cluster, part, rank, h, i0, tid,
                                              h_blk);
    sgt::cp_async_wait_all();
    __syncthreads();

    // ---- (3) per micro-block: decisions, then the delayed update -------
    // (the two roles in code paths of their own, so that neither holds the
    // other's registers: they meet at the same non-aligned barriers in the
    // same order)
    if (warp < sgt::kMmaWarps) {
#pragma unroll 1
      for (int m = 0; m + 1 < NM; ++m) {
        float4 a[B / 128][2][2];
        load_delayed<B>(a, J, n_pad, i0, C * m, warp, lane);
        sgt::block_barrier();  // ds and the micro-block's spins in place
        delayed_update<B, PLANES>(a, C * m, warp, lane, ds_w, h_blk);
        sgt::block_barrier();  // the later rows' fields are up to date
      }
      sgt::block_barrier();  // the last micro-block's spins are in place
    } else {
#pragma unroll 1
      for (int m = 0; m < NM; ++m) {
        if (lane < CPB)
          decide_micro(m, lane, jmb, h_blk, s_blk, th_blk, ds_w, de_acc,
                       cnt_acc);
        sgt::block_barrier();
        if (m + 1 < NM) sgt::block_barrier();
      }
    }

    // ---- (4) the block's new spins: the owner's shared memory, and out -
    for (int e = tid; e < B * CPB; e += CL_THREADS) {
      const int row = i0 + e / CPB, c = rank * CPB + e % CPB;
      sgt::store_owner_spin(cluster, spin_h, sw, rpb, c, row, s_blk[e]);
      if (r0 + c < R) spins[(size_t)row * R + r0 + c] = s_blk[e];
    }
    cluster.sync();  // partials read, spins in place; nobody exits early
  }
  if (warp == DECIDER && lane < CPB && r0 + rank * CPB + lane < R) {
    de_out[r0 + rank * CPB + lane] = de_acc;
    cnt_out[r0 + rank * CPB + lane] = cnt_acc;
  }
}

template <int B, int RULE, int PLANES>
cudaError_t launch_cluster(cudaStream_t stream, const float* J, const float* h,
                           const float* mask, float* spins, const float* beta,
                           const float* u, uint32_t k0, uint32_t k1,
                           const unsigned long long* seed_ptr, float* de,
                           int* cnt, int n_pad, int R) {
  static size_t allowed = 0;
  return sgt::launch_clusters(folded_cluster_kernel<B, RULE, PLANES>, R, 1,
                              CL_THREADS, folded_smem_bytes(n_pad, B), allowed,
                              stream, nullptr, J, h, mask, spins, beta, u, k0,
                              k1, seed_ptr, de, cnt, n_pad, R);
}

template <int B>
cudaError_t dispatch_cluster(int rule, int planes, cudaStream_t stream,
                             const float* J, const float* h,
                             const float* mask, float* spins,
                             const float* beta, const float* u, uint32_t k0,
                             uint32_t k1, const unsigned long long* seed_ptr,
                             float* de, int* cnt, int n_pad, int R) {
  auto fn = rule == 0
      ? (planes == 1 ? launch_cluster<B, 0, 1> : launch_cluster<B, 0, 3>)
      : (planes == 1 ? launch_cluster<B, 1, 1> : launch_cluster<B, 1, 3>);
  return fn(stream, J, h, mask, spins, beta, u, k0, k1, seed_ptr, de, cnt,
            n_pad, R);
}

// ---- the one-block float32 kernel (cluster = 1) ------------------------
constexpr int THREADS = 256;  // 8 warps
constexpr int RT = 32;        // replica columns per thread block (= lanes)

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
// seed_ptr) plus micro, which must be 32: cluster == 8 runs the cluster
// kernel on `planes` (1 or 3) bf16 planes of J, cluster == 1 the one-block
// float32 kernel. Returns the launch's CUDA error (0 on success).
int sgt_metropolis_folded(const float* J, const float* h, const float* mask,
                          float* spins, const float* beta, const float* u,
                          unsigned long long seed,
                          const unsigned long long* seed_ptr, float* de,
                          int* cnt, int n_pad, int R, int block_size, int rule,
                          int micro, int planes, int cluster, void* stream) {
  if (R < 1 || n_pad < 128 || n_pad % 128 != 0 || n_pad % block_size != 0 ||
      rule < 0 || rule > 1 || reinterpret_cast<uintptr_t>(J) % 16 != 0 ||
      micro != C || (block_size != 128 && block_size != 256) ||
      (planes != 1 && planes != 3) || (cluster != 1 && cluster != CS))
    return (int)cudaErrorInvalidValue;
  const uint32_t k0 = (uint32_t)(seed & 0xffffffffull);
  const uint32_t k1 = (uint32_t)(seed >> 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == CS)
    return (int)(block_size == 256
        ? dispatch_cluster<256>(rule, planes, s, J, h, mask, spins, beta, u,
                                k0, k1, seed_ptr, de, cnt, n_pad, R)
        : dispatch_cluster<128>(rule, planes, s, J, h, mask, spins, beta, u,
                                k0, k1, seed_ptr, de, cnt, n_pad, R));
  const dim3 grid((R + RT - 1) / RT);
  const int err = block_size == 256
      ? launch<256>(rule, grid, s, J, h, mask, spins, beta, u, k0, k1,
                    seed_ptr, de, cnt, n_pad, R)
      : launch<128>(rule, grid, s, J, h, mask, spins, beta, u, k0, k1,
                    seed_ptr, de, cnt, n_pad, R);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block of the cluster kernel at this shape.
long long sgt_metropolis_folded_smem(int n_pad, int block_size) {
  return (long long)folded_smem_bytes(n_pad, block_size);
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
