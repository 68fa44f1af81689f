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
// What bounds it on the H100 (Np = 4096, R = 1024). The block fields are
// 2 Np^2 R = 3.44e10 FLOP per sweep: 513 us at the 67 TFLOP/s of the float32
// CUDA cores, 104 us on the bf16 tensor cores (989 TFLOP/s) with J split
// exactly into three bf16 planes, 35 us with one plane. The bytes (J 67 MB
// once, the spins read and written) are 30 us at 3.35 TB/s. The first
// version (dense_sweep.cuh's tile_sweep_kernel, one thread block per 8
// columns, float32 FMAs) streamed all of J through every one of 128 blocks,
// 8.6 GB per sweep from L2, and took 1845 us; 336 us of that were the Np
// dependent decisions of a column, which no tile width shortens.
//
// Design: cluster_sweep_kernel. A replica tile of RT = 72 columns is shared
// by a thread-block cluster of CS = 8 blocks of 9 warps, so J is streamed
// once per tile (15 times per sweep at R = 1024, 1.0 GB from L2).
//   * Why 72. The card holds 15 clusters of 8 at once (132 SMs in GPCs of
//     which one cannot hold two such clusters), so 1024 columns in tiles of
//     64 would be 16 clusters and two waves, twice the time (measured:
//     1330 us against 660 at R = 960). 72 columns make 15 tiles, one wave;
//     each block decides 9 columns with 9 warps, and warps 0..7 multiply.
//     Nine warps share the SM's four register files three to one, which
//     caps a thread at 168 registers.
//   * Split-K over the cluster. Block c keeps spin rows [c Np/8, (c+1) Np/8)
//     of the tile in its shared memory for the whole sweep, as bf16 (+-1 is
//     exact) in [column][row] order, and for every row-block multiplies
//     J[i0:i0+B, its rows] with them for all 72 columns.
//   * Tensor cores, exactly. J stays float32 in device memory. Each thread
//     loads float4s of J straight into mma.sync.m16n8k16 A fragments (warp w
//     owns rows 16w..16w+15 of the block, or 32 rows at B = 256; the k slots
//     of a fragment are permuted so that a float4 fills two slot pairs and
//     the matching B fragment is one 64-bit, conflict-free shared-memory
//     load), a batch of k-steps ahead of the products, and splits them in
//     registers into bf16 planes hi = bf16(x), mid = bf16(x - hi),
//     lo = bf16(x - hi - mid), which add back to x bit for bit. The planes'
//     products of one k-step (lo, mid, hi, chained in an accumulator that
//     starts at 0) are exact; each 16-row partial sum is then added to the
//     running field with a float32 add outside the tensor core, whose own
//     adds truncate. With PLANES = 1 only hi is multiplied: the wrapper asks
//     for it when mid and lo are zero everywhere (+-J, dyadic grids, J
//     already rounded to bf16). One cluster in turn prefetches the next
//     row-block's slice of J into L2.
//   * Reduce-scatter through distributed shared memory. Block c leaves its
//     partial fields in shared memory as part[d][k][9]; after a cluster
//     barrier block d adds the 8 blocks' partials of its own 9 columns in
//     block order (so the sum is deterministic), adds h, and
//   * decides with one warp per column (decide_rows): J's diagonal block
//     comes 32 rows at a time through two cp.async buffers, and a lane reads
//     J's row before the decision is known, so that only compare -> shuffle
//     -> FMA is on the chain of B dependent steps. The thresholds (Philox,
//     logf) are drawn before the barrier, while other warps still multiply.
//     The new spins go as float32 into the caller's [Np, R] array and as
//     bf16 into the shared memory of the block that owns those rows; a
//     second cluster barrier ends the row-block. Two cluster barriers per
//     row-block.
// Measured on the H100 (700 W) at Np = 4096, R = 1024, SK couplings (three
// planes): 753-777 us/sweep at B = 128 against 1833-1845, of which the
// fields are ~58%, the decisions ~23% and barriers, reduction and stores the
// rest; +-J or j_dtype = bfloat16 (one plane) 620-640 us.
// Shapes: n_pad % 128 == 0, any R (columns beyond R are dead: they never
// flip and store nothing). Problems: P stacked problems of one n_pad go in
// one launch, problem p on blockIdx.y (the counterpart of the JAX batch
// path's vmap, anneal/batch.py); the STACKED instantiations move their
// pointers to the problem's slice at entry (SGT_PROBLEM_SLICE) and nothing
// below changes, so a problem's decisions equal a one-problem launch's with
// its seed; one problem launches the unmoved instantiation. A cluster stays
// 8 blocks along x; at R = 16, 16 problems make 16 clusters, of which the
// card holds 15 at once (two waves, measured 2.1x one problem's time). The spins must be +-1. Shared memory per block is
// ~18 n_pad bytes of spins plus B-dependent buffers (147 KB at Np = 4096,
// B = 128; 219 KB at B = 256), which fits up to n_pad = 8320 at B = 128 and
// 4224 at B = 256 (metropolis_cuda.dense_tile). Beyond that the wrapper asks
// for cluster = 1: the first version's kernel, any n_pad, exact float32.
//
// Randomness. With u == nullptr the kernel draws its own uniforms with
// Philox4x32-10 keyed by the 64-bit sweep seed (philox.cuh); the counter is
// (global spin index, global replica index, 0, 0), so the stream does not
// depend on the tile or on B. Otherwise u is the caller's [Np, R] array.
// Either way rows with mask == 0 get u = 2, whose threshold is -inf.
//
// Precision. Every product is exact and every sum float32, in an order that
// is fixed per launch shape; built without --use_fast_math so logf/log1pf
// match torch's CUDA log/log1p. Glauber clamps u at 0.999999 in the log1p
// term, as the Pallas kernel does (philox.cuh: threshold).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_sweep.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CS = 8;              // thread blocks per cluster
constexpr int CPB = 9;             // columns a block decides: one per warp
constexpr int RT = CS * CPB;       // 72 replica columns per cluster
constexpr int NTILE = RT / 8;      // MMA n-tiles of 8 columns
constexpr int MMA_WARPS = 8;       // warps 0..7 multiply; all 9 decide
constexpr int THREADS = 32 * CPB;  // 288
constexpr int TILE_RT = 8;         // the one-block kernel's tile (cluster = 1)

// 32-bit words between two columns of a block's spin slice of `rpb` rows:
// rpb / 2 words of bf16 pairs, padded to 8 mod 32 so that the 64-bit
// B-fragment loads of a half-warp (4 columns x 4 word pairs) hit 32
// different banks.
__host__ __device__ constexpr int spin_stride_words(int rpb) {
  return rpb / 2 + (40 - (rpb / 2) % 32) % 32;
}

__host__ __device__ constexpr size_t cluster_smem_bytes(int n_pad, int B) {
  return (size_t)RT * spin_stride_words(n_pad / CS) * 4  // spins, bf16
         + (size_t)RT * B * 4                            // part[CS][B][CPB]
         + (size_t)2 * 32 * B * 4                        // J rows, 2 buffers
         + (size_t)B * CPB * 4;                          // fields [B][CPB]
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

// d += A (16 x 16, row) * B (16 x 8, col), bf16 in, float32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint2& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
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

// J[row0 + i, i0 .. i0 + B) for i = 0..31 into dst[32][B] with cp.async, as
// one group per thread (J is symmetric: these are columns row0.. of the
// diagonal block).
template <int B>
__device__ __forceinline__ void stage_rows_async(const float* __restrict__ J,
                                                 int n_pad, int row0, int i0,
                                                 int tid, float* dst) {
  for (int e = tid; e < 32 * B / 4; e += THREADS)
    cp_async16(dst + 4 * e, J + (size_t)(row0 + e / (B / 4)) * n_pad + i0 +
                                4 * (e % (B / 4)));
  cp_async_commit();
}

// The B dependent decisions of the row-block at i0 for one warp's column:
// lane l holds the field, spin and threshold of block rows l, l + 32, ...
// For each row the owner lane decides, a shuffle broadcasts ds, and every
// lane corrects its rows with J's row, which it has read from shared memory
// before the decision is known (ds = 0 adds nothing), so only compare ->
// shuffle -> FMA is on the chain. J's rows come 32 at a time through two
// buffers; the caller has started the copy of the first 32 into jst.
// Measured and not kept: the whole diagonal block copied at once at B = 128
// (the decisions no faster, the fields slower), and B / 32 consecutive rows
// per lane decided with one round of shuffles (no faster).
template <int B>
__device__ __forceinline__ void decide_rows(const float* __restrict__ J,
                                            int n_pad, int i0, int tid,
                                            float* jst, float (&f)[B / 32],
                                            float (&s)[B / 32],
                                            const float (&th)[B / 32],
                                            float& de_acc, int& cnt_acc) {
  constexpr int FPL = B / 32;
  const int lane = tid & 31;
#pragma unroll
  for (int t0 = 0; t0 < FPL; ++t0) {
    cp_async_wait_all();
    __syncthreads();  // rows 32 t0.. are in place; the other buffer is free
    if (t0 + 1 < FPL)
      stage_rows_async<B>(J, n_pad, i0 + 32 * (t0 + 1), i0, tid,
                          jst + ((t0 + 1) & 1) * 32 * B);
    const float* jb = jst + (t0 & 1) * 32 * B + lane;
#pragma unroll 16  // 4 deep measured 2-5% slower, 32 deep slower still
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

template <int B, int RULE, int PLANES, bool STACKED>
__global__ void __launch_bounds__(THREADS, 1)
cluster_sweep_kernel(const float* __restrict__ J, const float* __restrict__ h,
                     const float* __restrict__ mask, float* spins,
                     const float* __restrict__ beta,
                     const float* __restrict__ u, uint32_t k0, uint32_t k1,
                     const unsigned long long* __restrict__ seed_ptr,
                     float* __restrict__ de_out, int* __restrict__ cnt_out,
                     int n_pad, int R) {
  // problem blockIdx.y of a stacked launch (dense_sweep.cuh)
  if constexpr (STACKED) SGT_PROBLEM_SLICE(n_pad, R);
  sgt::device_seed(seed_ptr, k0, k1);
  constexpr int MT = B / 128;  // 16-row MMA tiles per multiplying warp
  // k-steps (16 spin rows) per batch of loads, fetched one batch ahead: 8
  // float4s per thread in flight (2 k-steps at B = 128 measured 16% slower),
  // but 4 at B = 256 with three planes, which otherwise spills its 168
  // registers (920 us/sweep against 802)
  constexpr int KB = (B == 256 && PLANES == 3) ? 1 : 4 / MT;
  constexpr int FPL = B / 32;
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = (int)blockIdx.x / CS, n_tiles = (int)gridDim.x / CS;
  const int rpb = n_pad / CS;  // spin rows this block keeps
  const int sw = spin_stride_words(rpb);
  uint32_t* spin_w = reinterpret_cast<uint32_t*>(smem);
  __nv_bfloat16* spin_h = reinterpret_cast<__nv_bfloat16*>(smem);
  float* part = reinterpret_cast<float*>(smem + (size_t)RT * sw * 4);
  float* jst = part + RT * B;       // [2][32][B]
  float* h_blk = jst + 2 * 32 * B;  // [B][CPB]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // MMA group and thread in group
  const int r0 = tile * RT;
  const int own = rank * CPB + warp;  // this warp's column of the tile
  int col[1] = {r0 + own};
  const bool live = col[0] < R;
  const float nib = live ? -0.5f / beta[col[0]] : 0.f;
  float de_acc[1] = {0.f};
  int cnt_acc[1] = {0};

  // this block's rows of the tile, [column][row] bf16; dead columns 0
  for (int e = tid; e < rpb * RT; e += THREADS) {
    const int c = e % RT, lr = e / RT;
    const float v =
        r0 + c < R ? spins[(size_t)(rank * rpb + lr) * R + r0 + c] : 0.f;
    spin_h[c * (2 * sw) + lr] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  const int nks = rpb / 16;
  for (int i0 = 0; i0 < n_pad; i0 += B) {
    // ---- (0) ahead of time: the first 32 rows of J's diagonal block for
    // the decisions, and (one cluster in turn) the next row-block's slice
    // of J into L2, so that no cluster waits for device memory
    stage_rows_async<B>(J, n_pad, i0, i0, tid, jst);
    if (i0 + B < n_pad && tile == (i0 / B) % n_tiles) {
      const int segs = (rpb + 31) / 32;  // 128-byte lines per row
      for (int e = tid; e < B * segs; e += THREADS) {
        const float* p = J + (size_t)(i0 + B + e / segs) * n_pad +
                         rank * rpb + 32 * (e % segs);
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
      }
    }

    // ---- (1) partial block fields of the cluster's 72 columns ----------
    if (warp < MMA_WARPS) {
      float acc[MT][NTILE][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTILE; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
      // rows g and g + 8 of each of the warp's MMA tiles, columns 4t..4t+3
      // of each k-step of this block's slice of J
      const float* jbase =
          J + (size_t)(i0 + 16 * MT * warp + g) * n_pad + rank * rpb + 4 * t;
      float4 cur[KB][MT][2], nxt[KB][MT][2];
      load_batch<KB, MT>(cur, jbase, n_pad, 0, nks);
      for (int ks = 0; ks < nks; ks += KB) {
        load_batch<KB, MT>(nxt, jbase, n_pad, ks + KB, nks);
#pragma unroll
        for (int ku = 0; ku < KB; ++ku) {
          if (ks + ku < nks) {
            uint2 bf[NTILE];  // spins of rows 16 (ks + ku) + 4t .. + 3
#pragma unroll
            for (int nt = 0; nt < NTILE; ++nt)
              bf[nt] = *reinterpret_cast<const uint2*>(
                  spin_w + (8 * nt + g) * sw + 8 * (ks + ku) + 2 * t);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const float4 top = cur[ku][mt][0], bot = cur[ku][mt][1];
              uint32_t ah[4], am[4], al[4];
              split_pair<PLANES>(top.x, top.y, ah[0], am[0], al[0]);
              split_pair<PLANES>(bot.x, bot.y, ah[1], am[1], al[1]);
              split_pair<PLANES>(top.z, top.w, ah[2], am[2], al[2]);
              split_pair<PLANES>(bot.z, bot.w, ah[3], am[3], al[3]);
              // The planes' products of one k-step are chained in the
              // tensor core from 0 (lo, mid, hi; each plane over all n-tiles
              // before the next, so no MMA waits for the one before it);
              // the running field takes the sum with a float32 add.
              // Chaining more k-steps there measured slower (registers).
              float d[NTILE][4];
#pragma unroll
              for (int nt = 0; nt < NTILE; ++nt)
#pragma unroll
                for (int q = 0; q < 4; ++q) d[nt][q] = 0.f;
              if (PLANES == 3) {
#pragma unroll
                for (int nt = 0; nt < NTILE; ++nt) mma_bf16(d[nt], al, bf[nt]);
#pragma unroll
                for (int nt = 0; nt < NTILE; ++nt) mma_bf16(d[nt], am, bf[nt]);
              }
#pragma unroll
              for (int nt = 0; nt < NTILE; ++nt) mma_bf16(d[nt], ah, bf[nt]);
#pragma unroll
              for (int nt = 0; nt < NTILE; ++nt)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[mt][nt][q] += d[nt][q];
            }
          }
        }
#pragma unroll
        for (int ku = 0; ku < KB; ++ku)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) cur[ku][mt][hf] = nxt[ku][mt][hf];
      }
      // part[d][k][CPB]: the columns that block d decides, for block row k
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTILE; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = 16 * (MT * warp + mt) + g + 8 * (q >> 1);
            const int ct = 8 * nt + 2 * t + (q & 1);
            part[((ct / CPB) * B + row) * CPB + ct % CPB] = acc[mt][nt][q];
          }
    }
    // spins and thresholds of this warp's column, while others multiply
    float f[FPL], s[FPL], th[FPL];
#pragma unroll
    for (int k = 0; k < FPL; ++k)
      sgt::spin_state<RULE>(spins, u, mask, i0 + lane + 32 * k, col[0], live,
                            R, k0, k1, nib, s[k], th[k]);
    cluster.sync();  // every block's partials are in place

    // ---- (2) this block's columns: the partials in block order, + h ----
    static_assert(B * CPB % THREADS == 0, "B * CPB fields over the threads");
#pragma unroll
    for (int it = 0; it < B * CPB / THREADS; ++it) {  // all loads in flight
      const int e = tid + it * THREADS;
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < CS; ++c)
        v += cluster.map_shared_rank(part, c)[rank * B * CPB + e];
      h_blk[e] = v + h[i0 + e / CPB];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FPL; ++k) f[k] = h_blk[(lane + 32 * k) * CPB + warp];

    // ---- (3) B dependent decisions, one warp per column ----------------
    decide_rows<B>(J, n_pad, i0, tid, jst, f, s, th, de_acc[0], cnt_acc[0]);

    // ---- (4) the block's new spins: the owner's shared memory, and out -
#pragma unroll
    for (int k = 0; k < FPL; ++k) {
      const int row = i0 + lane + 32 * k;
      const int owner = row / rpb;
      __nv_bfloat16* dst = cluster.map_shared_rank(spin_h, owner) +
                           own * (2 * sw) + (row - owner * rpb);
      *dst = __float2bfloat16_rn(s[k]);
      if (live) spins[(size_t)row * R + col[0]] = s[k];
    }
    cluster.sync();  // partials read, spins in place; nobody exits early
  }
  sgt::store_totals<1>(de_acc, cnt_acc, col, R, de_out, cnt_out);
}

struct SweepArgs {
  const float* J;
  const float* h;
  const float* mask;
  float* spins;
  const float* beta;
  const float* u;
  uint32_t k0, k1;
  const unsigned long long* seed_ptr;
  float* de;
  int* cnt;
  int n_pad, R;
  int problems;  // P stacked problems on gridDim.y (1: one problem)
};

// Launches the cluster kernel, or with `clusters` only asks how many
// clusters of it the card holds at once.
template <int B, int RULE, int PLANES, bool STACKED>
cudaError_t launch_cluster_kernel(const SweepArgs& a, cudaStream_t stream,
                                  int* clusters) {
  auto kernel = cluster_sweep_kernel<B, RULE, PLANES, STACKED>;
  const size_t smem = cluster_smem_bytes(a.n_pad, B);
  static size_t allowed = 0;
  const cudaError_t err = sgt::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.R + RT - 1) / RT) * CS, a.problems);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  return cudaLaunchKernelEx(&cfg, kernel, a.J, a.h, a.mask, a.spins, a.beta,
                            a.u, a.k0, a.k1, a.seed_ptr, a.de, a.cnt,
                            a.n_pad, a.R);
}

// One problem runs the unmoved kernel (see dense_sweep.cuh).
template <int B, int RULE, int PLANES>
cudaError_t launch_cluster(const SweepArgs& a, cudaStream_t stream,
                           int* clusters) {
  return a.problems > 1
             ? launch_cluster_kernel<B, RULE, PLANES, true>(a, stream, clusters)
             : launch_cluster_kernel<B, RULE, PLANES, false>(a, stream,
                                                             clusters);
}

template <int B>
cudaError_t dispatch_cluster(int rule, int planes, const SweepArgs& a,
                             cudaStream_t stream, int* clusters) {
  if (rule == 0)
    return planes == 1 ? launch_cluster<B, 0, 1>(a, stream, clusters)
                       : launch_cluster<B, 0, 3>(a, stream, clusters);
  return planes == 1 ? launch_cluster<B, 1, 1>(a, stream, clusters)
                     : launch_cluster<B, 1, 3>(a, stream, clusters);
}

// The one-block kernel: one chain per warp; the field loop unrolled 16
// deep, the decisions 4.
template <int B, bool STACKED>
cudaError_t launch_tile_kernel(int rule, const SweepArgs& a,
                               cudaStream_t stream) {
  const dim3 grid((a.R + TILE_RT - 1) / TILE_RT, a.problems);
  if (rule == 0) {
    sgt::tile_sweep_kernel<B, 0, 1, 16, 4, STACKED><<<grid, 256, 0, stream>>>(
        a.J, a.h, a.mask, a.spins, a.beta, a.u, a.k0, a.k1, a.seed_ptr,
        a.de, a.cnt, a.n_pad, a.R);
  } else {
    sgt::tile_sweep_kernel<B, 1, 1, 16, 4, STACKED><<<grid, 256, 0, stream>>>(
        a.J, a.h, a.mask, a.spins, a.beta, a.u, a.k0, a.k1, a.seed_ptr,
        a.de, a.cnt, a.n_pad, a.R);
  }
  return cudaGetLastError();
}

template <int B>
cudaError_t launch_tile(int rule, const SweepArgs& a, cudaStream_t stream) {
  return a.problems > 1 ? launch_tile_kernel<B, true>(rule, a, stream)
                        : launch_tile_kernel<B, false>(rule, a, stream);
}

bool bad_shape(int n_pad, int R, int block_size, int rule, int planes,
               int cluster, int problems) {
  return R < 1 || problems < 1 || problems > 65535 || n_pad < 128 ||
         n_pad % 128 != 0 ||
         (block_size != 128 && block_size != 256) ||
         n_pad % block_size != 0 || rule < 0 || rule > 1 ||
         (planes != 1 && planes != 3) || (cluster != 1 && cluster != CS);
}

}  // namespace

extern "C" {

// One sweep of `problems` stacked problems on `stream`, problem p on
// gridDim.y. Returns the launch's CUDA error (0 on success). The caller
// checks shapes: J [P, n_pad, n_pad] (16-byte aligned), h and mask
// [P, n_pad], spins (+-1) and u [P, n_pad, R] row-major, beta/de/cnt
// [P, R]; n_pad a multiple of 128 and of block_size, block_size in
// {128, 256}, rule in {0, 1}. cluster == 8 runs the cluster kernel with
// planes in {1, 3} bf16 planes of J (1 only where every problem's J is
// exact in bf16); cluster == 1 the one-block float32 kernel. u == nullptr
// selects the in-kernel Philox stream, keyed by `seed` (every problem), or
// by the seed at seed_ptr[p] (device memory, one per problem) where that is
// not null: problem p then makes the decisions of a one-problem launch on
// its slice with that seed.
int sgt_metropolis_sweep_stacked(const float* J, const float* h,
                                 const float* mask, float* spins,
                                 const float* beta, const float* u,
                                 unsigned long long seed,
                                 const unsigned long long* seed_ptr, float* de,
                                 int* cnt, int n_pad, int R, int block_size,
                                 int rule, int planes, int cluster,
                                 int problems, void* stream) {
  if (bad_shape(n_pad, R, block_size, rule, planes, cluster, problems) ||
      reinterpret_cast<uintptr_t>(J) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const SweepArgs a = {J, h, mask, spins, beta, u,
                       (uint32_t)(seed & 0xffffffffull),
                       (uint32_t)(seed >> 32), seed_ptr, de, cnt, n_pad, R,
                       problems};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 1)
    return (int)(block_size == 256 ? launch_tile<256>(rule, a, s)
                                   : launch_tile<128>(rule, a, s));
  return (int)(block_size == 256
                   ? dispatch_cluster<256>(rule, planes, a, s, nullptr)
                   : dispatch_cluster<128>(rule, planes, a, s, nullptr));
}

// One sweep of one problem: the stacked launch at P = 1 (J [n_pad, n_pad],
// h and mask [n_pad], spins and u [n_pad, R], beta/de/cnt [R]).
int sgt_metropolis_sweep(const float* J, const float* h, const float* mask,
                         float* spins, const float* beta, const float* u,
                         unsigned long long seed,
                         const unsigned long long* seed_ptr, float* de,
                         int* cnt, int n_pad, int R, int block_size, int rule,
                         int planes, int cluster, void* stream) {
  return sgt_metropolis_sweep_stacked(J, h, mask, spins, beta, u, seed,
                                      seed_ptr, de, cnt, n_pad, R, block_size,
                                      rule, planes, cluster, 1, stream);
}

// The number of clusters of the cluster kernel that the card holds at once
// at this shape, into *clusters. Returns a CUDA error (0 on success).
int sgt_metropolis_sweep_clusters(int n_pad, int R, int block_size, int planes,
                                  int* clusters) {
  if (bad_shape(n_pad, R, block_size, 0, planes, CS, 1))
    return (int)cudaErrorInvalidValue;
  const SweepArgs a = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                       0u, 0u, nullptr, nullptr, nullptr, n_pad, R, 1};
  return (int)(block_size == 256
                   ? dispatch_cluster<256>(0, planes, a, nullptr, clusters)
                   : dispatch_cluster<128>(0, planes, a, nullptr, clusters));
}

// Dynamic shared memory per block of the cluster kernel at this shape.
long long sgt_metropolis_sweep_smem(int n_pad, int block_size) {
  return (long long)cluster_smem_bytes(n_pad, block_size);
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
