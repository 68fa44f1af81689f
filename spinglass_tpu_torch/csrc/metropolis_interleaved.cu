// K6 on Hopper: K1's sweep with the replica tile split into NC chains
// (NC = 2 or 4) whose decisions are stepped in interleaved order.
//
// Replaces the Pallas TPU kernel spinglass_tpu/kernels/metropolis_pallas.py
// (_make_kernel_interleaved, built by _build_call, driven by
// FusedSweep(interleave=n)). Makes exactly the decisions of K1
// (metropolis_sweep.cu) and of a sequential sweep: every operation is per
// replica column, and the chains only partition the columns, as in the
// TPU kernel: chain c owns columns [c RT/NC, (c+1) RT/NC) of the tile.
//
// What bounds it on the H100 (Np = 4096, R = 1024): the work of K1, 2 Np^2 R
// = 3.44e10 FLOP per plane of J, 104 us on the bf16 tensor cores with three
// planes (35 us with one); J once and the spins read and written are 30 us
// at 3.35 TB/s. The first version (dense_sweep.cuh's tile_sweep_kernel at
// 8 NC columns per thread block, float32 FMAs) streamed all of J from L2
// through every block and took 3.5 ms (2 chains) and 8.3 ms (4 chains).
//
// Design: interleaved_cluster_kernel, K1's cluster design
// (cluster_sweep.cuh): a 72-column replica tile per cluster of 8 blocks of
// 9 warps, each block keeping Np/8 spin rows as bf16, the block fields from
// mma.sync on J's exact bf16 planes by warps 0..7
// (SGT_CLUSTER_FIELD_PARTIALS), split-K over the cluster and reduced in
// block order; two cluster barriers per row-block. The decisions are where
// the TPU kernel's idea lives: one column per decision warp, in K1's column
// order (column 9 rank + warp), so a chain's columns lie on consecutive
// blocks and the chains are stepped side by side by the SM's warp
// schedulers, as the TPU steps them in one core's vector unit; a chain's
// compare -> shuffle -> FMA latency hides under the other warps'. Measured
// and not kept (PERF.md section 6): NC columns per warp, one of each chain,
// stepped in interleaved order within the warp (ceil(9 / NC) decision
// warps), 15-17% slower at 2 chains and 71-74% at 4 (B = 128), 51% and 67%
// at B = 256, since fewer warps then carry the dependent steps; every
// chain spread over every block (slot q of block rank holding chain
// (q + rank) % NC), within 2% at B = 128 but 20% slower at 256, where a
// block's 9 reads and writes of a spin row touch up to 9 sectors (K1's
// order: 1 or 2). So the cluster kernel does not depend on NC.
// Measured on the H100 (700 W) at Np = 4096, R = 1024, SK couplings (three
// planes): 771-776 us/sweep at 2 and 4 chains and both blocks, K1's time
// within 1% (3.2-3.6 ms and 7.6-8.3 ms for the first version).
// Shared memory: K1's layout, so the cluster kernel takes K1's shapes
// (n_pad up to 8320 at B = 128 and 4224 at B = 256,
// metropolis_cuda.dense_tile). Beyond that the wrapper asks for cluster =
// 1: the first version's one-block float32 kernel, dense_sweep.cuh's
// tile_sweep_kernel at NC chains per warp.
//
// Randomness and masks as in K1: Philox4x32-10 keyed by the 64-bit sweep
// seed with counter (spin, replica) unless u is given; rows with mask == 0
// get u = 2. Columns beyond R never flip and are never stored. Precision as
// K1's: every product exact, every sum float32 in K1's order.

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
constexpr int CPB = sgt::kCPB;     // columns a block decides: one per warp
constexpr int CRT = sgt::kRT;      // 72 replica columns per cluster
constexpr int THREADS = 32 * CPB;  // 288

__host__ __device__ constexpr size_t interleaved_smem_bytes(int n_pad, int B) {
  return sgt::cluster_spin_bytes(n_pad)  // spins, bf16
         + (size_t)CRT * B * 4           // part[CS][B][CPB]
         + (size_t)2 * 32 * B * 4        // J rows, 2 buffers
         + (size_t)B * CPB * 4;          // fields [B][CPB]
}

// The B dependent decisions of the row-block at i0 for the warp's column:
// lane l holds the field, spin and threshold of block rows l, l + 32, ...;
// per row the owner lane decides, a shuffle broadcasts ds, and every lane
// corrects its rows with J's row, read from shared memory before the
// decision is known, so only compare -> shuffle -> FMA is on the chain.
// J's rows come 32 at a time through two cp.async buffers; the caller has
// started the copy of the first 32 into jst.
template <int B>
__device__ __forceinline__ void decide_column(const float* __restrict__ J,
                                              int n_pad, int i0, int tid,
                                              float* jst, float (&f)[B / 32],
                                              float (&s)[B / 32],
                                              const float (&th)[B / 32],
                                              float& de_acc, int& cnt_acc) {
  constexpr int FPL = B / 32;
  const int lane = tid & 31;
#pragma unroll
  for (int t0 = 0; t0 < FPL; ++t0) {
    sgt::cp_async_wait_all();
    __syncthreads();  // rows 32 t0.. are in place; the other buffer is free
    if (t0 + 1 < FPL)
      sgt::stage_rows_async<B, 32, THREADS>(J, n_pad, i0 + 32 * (t0 + 1), i0,
                                            tid,
                                            jst + ((t0 + 1) & 1) * 32 * B);
    const float* jb = jst + (t0 & 1) * 32 * B + lane;
#pragma unroll 16
    for (int src = 0; src < 32; ++src) {
      float jv[FPL];
#pragma unroll
      for (int k = 0; k < FPL; ++k) jv[k] = jb[src * B + 32 * k];
      const float sv = s[t0], fv = f[t0];
      const bool accept = sv * fv < th[t0];
      const float ds = accept ? -2.f * sv : 0.f;
      const float dsb = __shfl_sync(sgt::kFull, ds, src);
      if (lane == src) {
        s[t0] = sv + ds;
        de_acc -= ds * fv;
        cnt_acc += accept ? 1 : 0;
      }
#pragma unroll
      for (int k = 0; k < FPL; ++k) f[k] = fmaf(jv[k], dsb, f[k]);
    }
  }
}

template <int B, int RULE, int PLANES>
__global__ void __launch_bounds__(THREADS, 1)
interleaved_cluster_kernel(const float* __restrict__ J,
                           const float* __restrict__ h,
                           const float* __restrict__ mask, float* spins,
                           const float* __restrict__ beta,
                           const float* __restrict__ u, uint32_t k0,
                           uint32_t k1,
                           const unsigned long long* __restrict__ seed_ptr,
                           float* __restrict__ de_out,
                           int* __restrict__ cnt_out, int n_pad, int R) {
  sgt::device_seed(seed_ptr, k0, k1);
  constexpr int FPL = B / 32;
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = (int)blockIdx.x / CS, n_tiles = (int)gridDim.x / CS;
  const int rpb = n_pad / CS;  // spin rows this block keeps
  const int sw = sgt::spin_stride_words(rpb);
  uint32_t* spin_w = reinterpret_cast<uint32_t*>(smem);
  __nv_bfloat16* spin_h = reinterpret_cast<__nv_bfloat16*>(smem);
  float* part = reinterpret_cast<float*>(smem + (size_t)CRT * sw * 4);
  float* jst = part + CRT * B;       // [2][32][B]
  float* h_blk = jst + 2 * 32 * B;   // [B][CPB]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // MMA group and thread in group
  const int r0 = tile * CRT;
  const int own = rank * CPB + warp;  // this warp's column of the tile
  int col[1] = {r0 + own};
  const bool live = col[0] < R;
  const float nib = live ? -0.5f / beta[col[0]] : 0.f;
  float de_acc[1] = {0.f};
  int cnt_acc[1] = {0};

  // this block's rows of the tile, [column][row] bf16; dead columns 0
  sgt::load_tile_spins<THREADS>(spins, spin_h, sw, rank, rpb, r0, R, tid);
  __syncthreads();

  const int nks = rpb / 16;
  for (int i0 = 0; i0 < n_pad; i0 += B) {
    // ---- (0) ahead of time: the first 32 rows of J's diagonal block for
    // the decisions, and (one cluster in turn) the next row-block's slice
    // of J into L2
    sgt::stage_rows_async<B, 32, THREADS>(J, n_pad, i0, i0, tid, jst);
    if (i0 + B < n_pad && tile == (i0 / B) % n_tiles)
      sgt::prefetch_rows_l2<B, THREADS>(J, n_pad, i0 + B, rank, rpb, tid);

    // ---- (1) partial block fields of the cluster's 72 columns ----------
    if (warp < sgt::kMmaWarps)
      SGT_CLUSTER_FIELD_PARTIALS(B, PLANES, J, n_pad, i0, rank, rpb, warp,
                                 g, t, nks, spin_w, sw, part);
    // spins and thresholds of this warp's column, while others multiply
    float f[FPL], s[FPL], th[FPL];
#pragma unroll
    for (int k = 0; k < FPL; ++k)
      sgt::spin_state<RULE>(spins, u, mask, i0 + lane + 32 * k, col[0], live,
                            R, k0, k1, nib, s[k], th[k]);
    cluster.sync();  // every block's partials are in place

    // ---- (2) this block's columns: the partials in block order, + h ----
    sgt::cluster_reduce_fields<B, THREADS>(cluster, part, rank, h, i0, tid,
                                           h_blk);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FPL; ++k) f[k] = h_blk[(lane + 32 * k) * CPB + warp];

    // ---- (3) B dependent decisions, the chains side by side ------------
    decide_column<B>(J, n_pad, i0, tid, jst, f, s, th, de_acc[0],
                     cnt_acc[0]);

    // ---- (4) the block's new spins: the owner's shared memory, and out -
#pragma unroll
    for (int k = 0; k < FPL; ++k) {
      const int row = i0 + lane + 32 * k;
      sgt::store_owner_spin(cluster, spin_h, sw, rpb, own, row, s[k]);
      if (live) spins[(size_t)row * R + col[0]] = s[k];
    }
    cluster.sync();  // partials read, spins in place; nobody exits early
  }
  sgt::store_totals<1>(de_acc, cnt_acc, col, R, de_out, cnt_out);
}

template <int B, int RULE, int PLANES>
cudaError_t launch_cluster(cudaStream_t stream, const float* J, const float* h,
                           const float* mask, float* spins, const float* beta,
                           const float* u, uint32_t k0, uint32_t k1,
                           const unsigned long long* seed_ptr, float* de,
                           int* cnt, int n_pad, int R) {
  static size_t allowed = 0;
  return sgt::launch_clusters(interleaved_cluster_kernel<B, RULE, PLANES>, R,
                              1, THREADS, interleaved_smem_bytes(n_pad, B),
                              allowed, stream, nullptr, J, h, mask, spins,
                              beta, u, k0, k1, seed_ptr, de, cnt, n_pad, R);
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
template <int B, int NC>
void launch_tile(int rule, dim3 grid, cudaStream_t stream, const float* J,
                 const float* h, const float* mask, float* spins,
                 const float* beta, const float* u, uint32_t k0, uint32_t k1,
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
// seed_ptr) plus nchains in {2, 4}: cluster == 8 runs the cluster kernel on
// `planes` (1 or 3) bf16 planes of J, cluster == 1 the one-block float32
// kernel (8 * nchains columns per thread block). Returns the launch's CUDA
// error (0 on success).
int sgt_metropolis_interleaved(const float* J, const float* h,
                               const float* mask, float* spins,
                               const float* beta, const float* u,
                               unsigned long long seed,
                               const unsigned long long* seed_ptr, float* de,
                               int* cnt, int n_pad, int R, int block_size,
                               int rule, int nchains, int planes, int cluster,
                               void* stream) {
  if (R < 1 || n_pad < 128 || n_pad % 128 != 0 || n_pad % block_size != 0 ||
      rule < 0 || rule > 1 || reinterpret_cast<uintptr_t>(J) % 16 != 0 ||
      (nchains != 2 && nchains != 4) ||
      (block_size != 128 && block_size != 256) ||
      (planes != 1 && planes != 3) || (cluster != 1 && cluster != CS))
    return (int)cudaErrorInvalidValue;
  const uint32_t k0 = (uint32_t)(seed & 0xffffffffull);
  const uint32_t k1 = (uint32_t)(seed >> 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == CS) {
    auto fn = block_size == 256 ? dispatch_cluster<256> : dispatch_cluster<128>;
    return (int)fn(rule, planes, s, J, h, mask, spins, beta, u, k0, k1,
                   seed_ptr, de, cnt, n_pad, R);
  }
  const dim3 grid((R + 8 * nchains - 1) / (8 * nchains));
  auto fn = block_size == 256
      ? (nchains == 2 ? launch_tile<256, 2> : launch_tile<256, 4>)
      : (nchains == 2 ? launch_tile<128, 2> : launch_tile<128, 4>);
  fn(rule, grid, s, J, h, mask, spins, beta, u, k0, k1, seed_ptr, de, cnt,
     n_pad, R);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block of the cluster kernel at this shape.
long long sgt_metropolis_interleaved_smem(int n_pad, int block_size) {
  return (long long)interleaved_smem_bytes(n_pad, block_size);
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
