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
// What bounds it on the H100 (Np = 4096, R = 1024): the work of K1, 2 Np^2 R
// = 3.44e10 FLOP per plane of J, 104 us on the bf16 tensor cores with three
// planes (35 us with one); J once and the spins read and written are 30 us
// at 3.35 TB/s. K1 spends ~58% of its time on the fields and ~23% on the B
// dependent decisions of each row-block, one after the other; the pipeline
// hides the decisions under the next row-block's fields.
//
// Design: pipelined_cluster_kernel, on K1's cluster (cluster_sweep.cuh): a
// 72-column replica tile per cluster of 8 blocks, each block keeping Np/8
// spin rows as bf16, the fields from mma.sync on J's exact bf16 planes,
// split-K over the cluster and reduced in block order. Each block runs two
// groups of warps, in loops of their own:
//   * warps 0..7 (fields) compute the partials of H_pre(b+1) while
//   * warps 8..10 (decisions; 3 columns each, interleaved as in K6: 11
//     warps keep K1's 168 registers a thread, 17 would not) decide block b
//     with K1's in-block corrections, J's diagonal rows coming RS = 32
//     (B = 256: 16) at a time through two cp.async buffers on the group's
//     named barrier.
//   * The repair, J[b+1, b] @ ds_b, on the tensor cores: the owner lane
//     writes each ds (0, +-2: exact in bf16) to shared memory, and at the
//     start of round b+1 the field warps add J's sub-diagonal block (split
//     into its planes in registers) times ds_b (9 columns padded to 16)
//     with mma.sync. (Summed flip by flip in the decision warps' registers
//     instead, it measured ~3% faster at B = 128 and spilled at B = 256;
//     one design for both blocks was kept: PERF.md section 6.)
//   * The race: the field warps read every spin row of the tile while the
//     decisions flip block b's rows, so the decision warps keep block b's
//     new spins in registers until a cluster barrier says that every
//     block's H_pre(b+1) partials are in place; only then do they store
//     them to the owners' shared memory (and out). H_pre(b+1) then misses
//     exactly block b's flips, which the repair restores.
// One round: H(b) (reduce, repair); cluster barrier (P(b) read, block
// b-1's spins stored); the fields of b+1 beside the thresholds and the
// decisions of b; cluster barrier; the stores. Two cluster barriers per
// row-block, as K1. The two groups meet there, and at the block barriers
// around the reduction, from loops of their own, so those barriers are
// forms without .aligned (cluster_sweep.cuh: block_barrier, cg's
// cluster.sync); each group's own barriers are named (GroupSync), reached
// by all its threads at one instruction. Shared memory: K1's, the J rows as above
// and the ds operand, so the cluster kernel takes n_pad up to 8320 at
// B = 128 and 5632 at B = 256 (metropolis_cuda.pipelined_tile).
//
// Beyond that the wrapper asks for cluster = 1: the first version's
// one-block float32 kernel, pipelined_kernel below. One thread block of 16
// warps owns 8 replica columns: warps 8-15 compute H_pre(b+1) with the
// shared float32 field phase (dense_sweep.cuh: field_partials) while warps
// 0-7, one per replica, decide block b with K1's decide_block, on named
// barriers of their own, H_pre double-buffered in shared memory; block b's
// spins wait in registers for the handover (__syncthreads), and all 512
// threads repair H_pre(b+1) with J[b+1, b] @ ds_b. It streams all of J per
// 8-column tile from L2.
//
// Randomness and masks as in K1: Philox4x32-10, counter (spin, replica),
// unless u is given; rows with mask == 0 get u = 2; columns beyond R never
// flip and are never stored. Precision: on the cluster every product is
// exact and every sum float32 in an order fixed per launch shape; the repair
// sums in the tensor core's order where K1 corrects flip by flip, so on
// Gaussian couplings the fields differ from K1's and the twin's in their
// last bits (on +-J with h on a dyadic grid every sum is exact: bitwise
// equal to K1 and the twin).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_sweep.cuh"
#include "dense_sweep.cuh"

namespace cg = cooperative_groups;

namespace {

// ---- the cluster kernel ------------------------------------------------
constexpr int CS = sgt::kCS;
constexpr int CPB = sgt::kCPB;
constexpr int CRT = sgt::kRT;                  // 72 replica columns
constexpr int DEC_WARPS = 3;                   // decision warps per block
constexpr int NC = CPB / DEC_WARPS;            // columns per decision warp
constexpr int DEC_THREADS = 32 * DEC_WARPS;
constexpr int FIELD_THREADS = 32 * sgt::kMmaWarps;
constexpr int CL_THREADS = FIELD_THREADS + DEC_THREADS;  // 352
using ChooserSync = sgt::GroupSync<1, DEC_THREADS>;
using FieldSync = sgt::GroupSync<2, FIELD_THREADS>;

// J rows (of the diagonal block, B floats each) per cp.async stage of the
// decisions
__host__ __device__ constexpr int stage_rows(int B) {
  return B == 256 ? 16 : 32;
}

// 32-bit words per column of the tensor-core repair's ds operand: B / 2
// bf16 pairs, padded to 8 mod 32 as the spins are
__host__ __device__ constexpr int ds_stride_words(int B) {
  return sgt::spin_stride_words(B);
}

__host__ __device__ constexpr size_t pipe_smem_bytes(int n_pad, int B) {
  return sgt::cluster_spin_bytes(n_pad)                     // spins, bf16
         + (size_t)CRT * B * 4                              // part[CS][B][CPB]
         + (size_t)2 * stage_rows(B) * B * 4                // J rows, 2 bufs
         + (size_t)B * CPB * 4                              // fields [B][CPB]
         + (size_t)16 * ds_stride_words(B) * 4;             // ds
}

// The B dependent decisions of the row-block at i0 for one decision warp's
// NC columns (K1's decide_rows at NC chains): lane l holds the fields,
// spins and thresholds of block rows l, l + 32, ...; for each row the owner
// lane decides column 0, 1, 2 in turn, a shuffle per column broadcasts ds,
// and every lane corrects its rows of each column with J's row, read from
// shared memory before the decision is known. Where there is a next block
// (NEXT), the owner lane also writes ds (0, +-2: exact in bf16) to the
// column's row of ds_h, the operand of the next round's repair. J's rows
// come RS at a time through two cp.async buffers; the caller has started
// the copy of the first RS (stage_pipe_rows).
template <int B>
__device__ __forceinline__ void stage_pipe_rows(const float* __restrict__ J,
                                                int n_pad, int row0, int i0,
                                                int dt, float* dst) {
  sgt::stage_rows_async<B, stage_rows(B), DEC_THREADS>(J, n_pad, row0, i0, dt,
                                                        dst);
}

template <int B, bool NEXT>
__device__ __forceinline__ void decide_pipe(
    const float* __restrict__ J, int n_pad, int i0, int dt, float* jst,
    __nv_bfloat16* ds_h, int dcol, float (&f)[NC][B / 32],
    float (&s)[NC][B / 32], const float (&th)[NC][B / 32],
    float (&de_acc)[NC], int (&cnt_acc)[NC]) {
  constexpr int FPL = B / 32, RS = stage_rows(B);
  constexpr int NST = B / RS, DSH = 2 * ds_stride_words(B);
  // rows decided per unrolled step: at B = 256, 8 steps hoist 64 loads of
  // J and spill the 168 registers of a thread
  constexpr int QU = B == 256 ? 2 : 8;
  const int lane = dt & 31;
#pragma unroll
  for (int st = 0; st < NST; ++st) {
    sgt::cp_async_wait_all();
    ChooserSync()();  // rows RS st.. are in place; the other buffer is free
    if (st + 1 < NST)
      stage_pipe_rows<B>(J, n_pad, i0 + RS * (st + 1), i0, dt,
                         jst + ((st + 1) & 1) * RS * B);
    const int t0 = st * RS / 32;  // the owner lanes' slot
    const float* jb = jst + (st & 1) * RS * B + lane;
#pragma unroll (QU)
    for (int q = 0; q < RS; ++q) {
      const int src = st * RS % 32 + q;
      float jv[FPL];
#pragma unroll
      for (int k = 0; k < FPL; ++k) jv[k] = jb[q * B + 32 * k];
      float dsb[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float sv = s[c][t0], fv = f[c][t0];
        const bool accept = sv * fv < th[c][t0];
        const float ds = accept ? -2.f * sv : 0.f;
        dsb[c] = __shfl_sync(sgt::kFull, ds, src);
        if (lane == src) {
          s[c][t0] = sv + ds;
          de_acc[c] -= ds * fv;
          cnt_acc[c] += accept ? 1 : 0;
          if (NEXT)
            ds_h[(dcol + c) * DSH + 32 * t0 + src] = __float2bfloat16_rn(ds);
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int k = 0; k < FPL; ++k) f[c][k] = fmaf(jv[k], dsb[c], f[c][k]);
    }
  }
}

// The spins and thresholds of the decision warp's NC columns at block rows
// lane, lane + 32, ... of the row-block at i0.
template <int B, int RULE>
__device__ __forceinline__ void draw_states(
    const float* spins, const float* __restrict__ u,
    const float* __restrict__ mask, int i0, int lane, const int (&col)[NC],
    const bool (&live)[NC], int R, uint32_t k0, uint32_t k1,
    const float (&nib)[NC], float (&s)[NC][B / 32], float (&th)[NC][B / 32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int k = 0; k < B / 32; ++k)
      sgt::spin_state<RULE>(spins, u, mask, i0 + lane + 32 * k, col[c],
                            live[c], R, k0, k1, nib[c], s[c][k], th[c][k]);
}

// The repair of the row-block at i0 (b >= 1) on the tensor cores, by one of
// the 8 field warps: h_blk[k][c] += sum_i J[i0 + k, i0 - B + i] ds[i][c]
// for the warp's 16-row tiles, ds the previous block's flips of this
// block's 9 columns (16 with zeros). Per k-step the planes' exact
// products are chained in the tensor core from 0; the k-steps' sums are
// added in float32, then to the field.
template <int B, int PLANES>
__device__ __forceinline__ void repair_fields(const float* __restrict__ J,
                                              int n_pad, int i0, int warp,
                                              int lane, const uint32_t* ds_w,
                                              float* h_blk) {
  // k-steps per batch of loads, one batch ahead (8 float4s a thread)
  constexpr int MT = B / 128, KB = 4 / MT, NKS = B / 16;
  constexpr int DSW = ds_stride_words(B);
  const int g = lane >> 2, t = lane & 3;
  const float* jbase =
      J + (size_t)(i0 + 16 * MT * warp + g) * n_pad + (i0 - B) + 4 * t;
  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
  float4 cur[KB][MT][2], nxt[KB][MT][2];
  sgt::load_batch<KB, MT>(cur, jbase, n_pad, 0, NKS);
#pragma unroll 1
  for (int ks = 0; ks < NKS; ks += KB) {
    sgt::load_batch<KB, MT>(nxt, jbase, n_pad, ks + KB, NKS);
#pragma unroll
    for (int ku = 0; ku < KB; ++ku) {
      uint2 bf[2];  // ds of rows 16 (ks + ku) + 4t .. + 3
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        bf[nt] = *reinterpret_cast<const uint2*>(
            ds_w + (8 * nt + g) * DSW + 8 * (ks + ku) + 2 * t);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t ah[4], am[4], al[4];
        sgt::split_tile<PLANES>(cur[ku][mt][0], cur[ku][mt][1], ah, am, al);
        float d[2][4];
        sgt::plane_products<PLANES, 2>(d, ah, am, al, bf);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] += d[nt][q];
      }
    }
#pragma unroll
    for (int ku = 0; ku < KB; ++ku)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) cur[ku][mt][hf] = nxt[ku][mt][hf];
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = 16 * (MT * warp + mt) + g + 8 * (q >> 1);
        const int ct = 8 * nt + 2 * t + (q & 1);
        if (ct < CPB) h_blk[row * CPB + ct] += acc[mt][nt][q];
      }
}

template <int B, int RULE, int PLANES>
__global__ void __launch_bounds__(CL_THREADS, 1)
pipelined_cluster_kernel(const float* __restrict__ J,
                         const float* __restrict__ h,
                         const float* __restrict__ mask, float* spins,
                         const float* __restrict__ beta,
                         const float* __restrict__ u, uint32_t k0, uint32_t k1,
                         const unsigned long long* __restrict__ seed_ptr,
                         float* __restrict__ de_out, int* __restrict__ cnt_out,
                         int n_pad, int R) {
  sgt::device_seed(seed_ptr, k0, k1);
  constexpr int FPL = B / 32;
  extern __shared__ __align__(16) unsigned char cluster_smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = (int)blockIdx.x / CS, n_tiles = (int)gridDim.x / CS;
  const int rpb = n_pad / CS;  // spin rows this block keeps
  const int sw = sgt::spin_stride_words(rpb);
  uint32_t* spin_w = reinterpret_cast<uint32_t*>(cluster_smem);
  __nv_bfloat16* spin_h = reinterpret_cast<__nv_bfloat16*>(cluster_smem);
  float* part = reinterpret_cast<float*>(cluster_smem + (size_t)CRT * sw * 4);
  float* jst = part + CRT * B;                             // [2][RS][B]
  float* h_blk = jst + 2 * stage_rows(B) * B;                     // [B][CPB]
  uint32_t* ds_w = reinterpret_cast<uint32_t*>(h_blk + B * CPB);  // [16][.]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // MMA group and thread in group
  const int r0 = tile * CRT;
  const int nb = n_pad / B;
  const int nks = rpb / 16;
  for (int e = tid; e < 16 * ds_stride_words(B); e += CL_THREADS)
    ds_w[e] = 0u;
  sgt::load_tile_spins<CL_THREADS>(spins, spin_h, sw, rank, rpb, r0, R, tid);
  __syncthreads();

  // The two groups run loops of their own (so that neither holds the
  // other's registers), meeting at the same non-aligned barriers in the
  // same order.
  if (warp < sgt::kMmaWarps) {
    // ---- the field warps: P(b+1), the partials of H_pre(b+1), in round b
    SGT_CLUSTER_FIELD_PARTIALS(B, PLANES, J, n_pad, 0, rank, rpb, warp, g, t,
                               nks, spin_w, sw, part);
    cluster.sync();
    for (int b = 0; b < nb; ++b) {
      // H(b) of this block's columns: H_pre(b), then J[b, b-1] @ ds_{b-1}
      sgt::cluster_reduce_fields<B, FIELD_THREADS>(cluster, part, rank, h,
                                                   b * B, tid, h_blk);
      if (b > 0) {
        FieldSync()();  // h_blk complete
        repair_fields<B, PLANES>(J, n_pad, b * B, warp, lane, ds_w, h_blk);
      }
      sgt::block_barrier();
      cluster.sync();  // P(b) read everywhere; b-1's spins in place
      if (b + 1 < nb)
        SGT_CLUSTER_FIELD_PARTIALS(B, PLANES, J, n_pad, (b + 1) * B, rank,
                                   rpb, warp, g, t, nks, spin_w, sw, part);
      cluster.sync();  // every block's P(b+1) is in place
    }
    cluster.sync();
    return;
  }

  // ---- the decision warps: block b in round b --------------------------
  const int dw = warp - sgt::kMmaWarps;      // 0..2
  const int dt = tid - 32 * sgt::kMmaWarps;  // the thread's index in the group
  __nv_bfloat16* ds_h = reinterpret_cast<__nv_bfloat16*>(ds_w);
  int own[NC], col[NC];  // the warp's columns: of the tile, of R
  bool live[NC];
  float nib[NC], de_acc[NC];
  int cnt_acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    own[c] = rank * CPB + dw * NC + c;
    col[c] = r0 + own[c];
    live[c] = col[c] < R;
    nib[c] = live[c] ? -0.5f / beta[col[c]] : 0.f;
    de_acc[c] = 0.f;
    cnt_acc[c] = 0;
  }
  cluster.sync();  // P(0) in place
  for (int b = 0; b < nb; ++b) {
    const int i0 = b * B;
    const bool next = b + 1 < nb;
    // ---- (0) the decisions' first rows of J; (one cluster in turn) the
    // slice of J that H_pre(b+2) multiplies, into L2
    stage_pipe_rows<B>(J, n_pad, i0, i0, dt, jst);
    if (b + 2 < nb && tile == b % n_tiles)
      sgt::prefetch_rows_l2<B, DEC_THREADS>(J, n_pad, i0 + 2 * B, rank, rpb,
                                            dt);
    // ---- (1) the field warps make H(b) of this block's columns ---------
    float f[NC][FPL], s[NC][FPL], th[NC][FPL];
    sgt::block_barrier();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int k = 0; k < FPL; ++k)
        f[c][k] = h_blk[(lane + 32 * k) * CPB + dw * NC + c];
    cluster.sync();  // P(b) read everywhere; b-1's spins in place

    // ---- (2) block b's spins, thresholds and decisions beside the fields
    // of b+1 (drawn in (1), the thresholds outlast the reduction and the
    // repair: PERF.md section 6)
    draw_states<B, RULE>(spins, u, mask, i0, lane, col, live, R, k0, k1, nib,
                         s, th);
    if (next)
      decide_pipe<B, true>(J, n_pad, i0, dt, jst, ds_h, dw * NC, f, s, th,
                           de_acc, cnt_acc);
    else
      decide_pipe<B, false>(J, n_pad, i0, dt, jst, ds_h, dw * NC, f, s, th,
                            de_acc, cnt_acc);
    cluster.sync();  // every block's P(b+1) is in place

    // ---- (3) block b's new spins: the owners' shared memory, and out ---
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int k = 0; k < FPL; ++k) {
        const int row = i0 + lane + 32 * k;
        sgt::store_owner_spin(cluster, spin_h, sw, rpb, own[c], row, s[c][k]);
        if (live[c]) spins[(size_t)row * R + col[c]] = s[c][k];
      }
  }
  cluster.sync();  // the last stores are done; nobody exits early
  sgt::store_totals<NC>(de_acc, cnt_acc, col, R, de_out, cnt_out);
}

template <int B, int RULE, int PLANES>
cudaError_t launch_cluster(cudaStream_t stream, const float* J, const float* h,
                           const float* mask, float* spins, const float* beta,
                           const float* u, uint32_t k0, uint32_t k1,
                           const unsigned long long* seed_ptr, float* de,
                           int* cnt, int n_pad, int R) {
  static size_t allowed = 0;
  return sgt::launch_clusters(pipelined_cluster_kernel<B, RULE, PLANES>, R, 1,
                              CL_THREADS, pipe_smem_bytes(n_pad, B), allowed,
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
                 uint32_t k0, uint32_t k1,
                 const unsigned long long* __restrict__ seed_ptr,
                 float* __restrict__ de_out, int* __restrict__ cnt_out,
                 int n_pad, int R) {
  sgt::device_seed(seed_ptr, k0, k1);
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
           const float* u, uint32_t k0, uint32_t k1,
           const unsigned long long* seed_ptr, float* de, int* cnt,
           int n_pad, int R) {
  const size_t bytes = sizeof(float) * smem_floats<B>();
  auto kernel = rule == 0 ? pipelined_kernel<B, 0> : pipelined_kernel<B, 1>;
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
// seed_ptr): cluster == 8 runs the cluster kernel on `planes` (1 or 3) bf16
// planes of J, cluster == 1 the one-block float32 kernel. Returns the
// launch's CUDA error (0 on success).
int sgt_metropolis_pipelined(const float* J, const float* h, const float* mask,
                             float* spins, const float* beta, const float* u,
                             unsigned long long seed,
                             const unsigned long long* seed_ptr, float* de,
                             int* cnt, int n_pad, int R, int block_size,
                             int rule, int planes, int cluster, void* stream) {
  if (R < 1 || n_pad < 128 || n_pad % 128 != 0 || n_pad % block_size != 0 ||
      rule < 0 || rule > 1 || reinterpret_cast<uintptr_t>(J) % 16 != 0 ||
      (block_size != 128 && block_size != 256) ||
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
long long sgt_metropolis_pipelined_smem(int n_pad, int block_size) {
  return (long long)pipe_smem_bytes(n_pad, block_size);
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
