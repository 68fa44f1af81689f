// K2 on Hopper: one whole colour-sorted sparse Metropolis/Glauber sweep.
//
// Replaces the Pallas TPU kernel spinglass_tpu/kernels/sparse.py
// (make_single_sweep_call, tables from build_single_tables, driven by
// SortedSparseTEngine._sweep_single). Spins are [NS, R] float32 (+-1) in the
// colour-sorted layout of build_sorted_t: the rows of colour c are the
// contiguous span [spans[c], spans[c+1]), and no two rows of one colour are
// coupled. For every replica column it makes exactly the decisions of the
// per-colour sweep (kernels/sparse.py:make_sorted_t_sweep):
//
//   for each colour c, in order, all rows i of c from the same spin state:
//     f_i  = h_i + sum_{k < deg_i} val[i, k] * s[idx[i, k]]      (in k order)
//     accept  <=>  s_i * f_i < th_i          (th = -inf on padding rows)
//     accepted: s_i = -s_i ;  dE += 2 s_i f_i ;  count += 1
//
// What bounds it on the H100. The work is small: at [10240, 1024] the spins
// are read and written once (2 x 41.9 MB), the tables are ~1.7 MB and a
// sweep does 6.3e7 FMAs and 1.05e7 Philox draws, so the least time is the
// bytes', 25.5 us at 3.35 TB/s (3.6 us at [10240, 128]). The cost is
// latency: a row's field is a chain deg -> idx[k] -> spin of the neighbour,
// and a sweep is 7-8 colours of such chains separated by barriers. The
// first version walked those chains in device memory (L2 round trips, ~11
// rows per thread per colour: 205-209 us/sweep at [10240, 1024], 76-77 at
// [10240, 128]).
//
// Design. Replica columns never interact, so ONE thread block of 1024
// threads owns a tile of RT columns for the whole sweep (one launch per
// sweep, no grid-wide sync) and
//   (1) keeps the tile's spins in shared memory as int8 [NS][RT] for the
//       whole sweep: read from the caller's array once (consecutive threads,
//       consecutive columns of a row), gathered, flipped and read back
//       there, written out once at the end. val * (float)s in k order is
//       the arithmetic of the float32 version, so the decisions are the
//       same on every input;
//   (2) gives each thread a whole row: its RT columns' fields live in
//       registers, one vector load fetches a neighbour's RT spins, and a
//       colour of ~1460 rows is one or two rows per thread instead of eleven
//       dependent chains;
//   (3) reads the tables transposed, idx_t / val_t [kmax][NS], four slots at
//       a time before the gathers, so the 32 rows of a warp read one
//       128-byte line per slot and the reads of a batch overlap: the tables
//       stream through L2/L1 instead of being chased.
// A __syncthreads() separates colours. Measured on the H100 (700 W):
// 130-131 us/sweep at [10240, 1024] (RT = 8), 66 at [10240, 256] (RT = 2),
// 57-58 at [10240, 128] (RT = 1), with one Philox run per column; with one
// run per four columns 109-110 us at R = 1024 (in turns against 129), 63 at
// R = 256 (65) and 57-58 at R = 128 (one run per row either way). What is
// left at R = 1024 is the second, 43% full pass over a colour's rows (two
// threads per row with 4 columns each measured slower, 149 us), the draws
// that remain and a conversion from int8 per gathered spin.
// RT is chosen by the wrapper (sparse_cuda.default_tile): about 128 blocks,
// RT <= 8, and NS * RT bytes inside the block's shared memory (NS <= 28672
// at RT = 8, 229376 at RT = 1). Beyond that the wrapper raises: no engine
// sends such a shape (the sparse engine takes K2 up to NS * R * 4 = 80 MiB,
// NS <= 163840 at R = 128).
//
// Randomness. th == nullptr selects the in-kernel Philox4x32-10 stream keyed
// by the 64-bit sweep seed with counter (sorted row, replica >> 2), whose
// four output words serve four neighbouring columns (philox.cuh,
// philox_uniform4): the stream of K3 (sparse_thresholds.cu), of K4
// (sparse_accept.cu) and of kernels/metropolis_cuda.py:philox_uniforms4. A
// thread runs the ten rounds once per four of its columns (twice at RT = 8,
// once at RT = 4; at RT = 1 and 2 once, keeping one or two words).
// mask[i] < 0 marks padding rows, whose threshold is -inf. Otherwise th is
// the caller's [NS, R] threshold array, already masked.
//
// Bookkeeping. dE and the count are summed per thread and column, then
// across the warp (shuffles) and the warps in order, so runs are
// deterministic. Exact float32 throughout; on +-J couplings with h on a
// dyadic grid every field and dE is exact, and the kernel equals its twin
// (kernels/sparse_cuda.py) bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int KBATCH = 4;  // table slots fetched together
constexpr int WARPS = THREADS / 32;
constexpr int MAX_RT = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int RT> struct TileWord;
template <> struct TileWord<1> { using T = uint8_t; };
template <> struct TileWord<2> { using T = uint16_t; };
template <> struct TileWord<4> { using T = uint32_t; };
template <> struct TileWord<8> { using T = uint2; };

// The RT spins of sorted row `row` as floats: one vector load from the
// int8 tile.
template <int RT>
__device__ __forceinline__ void load_row(const int8_t* tile, int row,
                                         float (&sv)[RT]) {
  using W = typename TileWord<RT>::T;
  const W w = *reinterpret_cast<const W*>(tile + (size_t)row * RT);
  int8_t b[RT];
  memcpy(b, &w, RT);
#pragma unroll
  for (int c = 0; c < RT; ++c) sv[c] = (float)b[c];
}

template <int RT, int RULE, bool HOST_TH>
__global__ void __launch_bounds__(THREADS, 1)
sparse_sweep_kernel(const int* __restrict__ idx_t,   // [kmax, NS]
                    const float* __restrict__ val_t, // [kmax, NS]
                    const int* __restrict__ deg,     // [NS]
                    const float* __restrict__ h,     // [NS]
                    const float* __restrict__ mask,  // [NS] 0 / -inf
                    const int* __restrict__ spans,   // [n_colors + 1]
                    int n_colors,
                    float* spins,                    // [NS, R], in place
                    const float* __restrict__ th,    // [NS, R] or nullptr
                    const float* __restrict__ beta,  // [R]
                    uint32_t k0, uint32_t k1,
                    const unsigned long long* __restrict__ seed_ptr,
                    float* __restrict__ de_out, int* __restrict__ cnt_out,
                    int n_sorted, int kmax, int R) {
  sgt::device_seed(seed_ptr, k0, k1);
  using W = typename TileWord<RT>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* tile = reinterpret_cast<int8_t*>(smem);  // [NS][RT]
  __shared__ float red_de[WARPS][MAX_RT];
  __shared__ int red_cnt[WARPS][MAX_RT];
  __shared__ float nib_s[MAX_RT];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col0 = blockIdx.x * RT;
  if (tid < RT)
    nib_s[tid] = (!HOST_TH && col0 + tid < R) ? -0.5f / beta[col0 + tid] : 0.f;
  // the tile in: consecutive threads, consecutive columns (dead columns +1)
  for (int e = tid; e < n_sorted * RT; e += THREADS) {
    const int c = e % RT;
    tile[e] = col0 + c < R ? (int8_t)spins[(size_t)(e / RT) * R + col0 + c]
                           : (int8_t)1;
  }
  __syncthreads();

  float de_acc[RT];
  int cnt_acc[RT];
#pragma unroll
  for (int c = 0; c < RT; ++c) {
    de_acc[c] = 0.f;
    cnt_acc[c] = 0;
  }

  for (int color = 0; color < n_colors; ++color) {
    const int lo = __ldg(spans + color), hi = __ldg(spans + color + 1);
    for (int i = lo + tid; i < hi; i += THREADS) {
      const int d = __ldg(deg + i);
      const float hv = __ldg(h + i);
      float f[RT];
#pragma unroll
      for (int c = 0; c < RT; ++c) f[c] = hv;
      // KBATCH slots at a time: their table reads go out together, then
      // the gathers. Slots past the row's degree hold val 0 and a valid
      // row, and add nothing.
      for (int kb = 0; kb < d; kb += KBATCH) {
        int j[KBATCH];
        float v[KBATCH];
#pragma unroll
        for (int q = 0; q < KBATCH; ++q) {
          const bool in = kb + q < kmax;
          const size_t e = (size_t)(kb + q) * n_sorted + i;
          j[q] = in ? __ldg(idx_t + e) : i;
          v[q] = in ? __ldg(val_t + e) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < KBATCH; ++q) {
          float sv[RT];
          load_row<RT>(tile, j[q], sv);
#pragma unroll
          for (int c = 0; c < RT; ++c) f[c] = fmaf(v[q], sv[c], f[c]);
        }
      }
      float so[RT];
      load_row<RT>(tile, i, so);
      const bool padded = !HOST_TH && __ldg(mask + i) < 0.f;
      bool any = false;
      // four columns per run of the Philox rounds (philox_uniform4): tiles
      // start at multiples of RT, so a tile of 4 or 8 columns is one or two
      // whole groups, and a tile of 1 or 2 picks its words from one group
      constexpr int QUADS = RT >= 4 ? RT / 4 : 1;
      constexpr int PER = RT >= 4 ? 4 : RT;  // columns taken from a group
#pragma unroll
      for (int q = 0; q < QUADS; ++q) {
        float u[4] = {0.f, 0.f, 0.f, 0.f};
        if (!HOST_TH && !padded)
          sgt::philox_uniform4((uint32_t)i, (uint32_t)(col0 >> 2) + q, k0, k1,
                               u);
        const int w0 = RT >= 4 ? 0 : (col0 & 3);  // first word of this tile
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          const int c = 4 * q + p;
          const int col = col0 + c;
          if (col < R) {
            float t;
            if (HOST_TH) {
              t = __ldg(th + (size_t)i * R + col);
            } else if (padded) {
              t = -INFINITY;
            } else {
              float uu = u[p];  // RT >= 4: word p; else word w0 + p
              if constexpr (RT == 1)
                uu = w0 == 0 ? u[0] : w0 == 1 ? u[1] : w0 == 2 ? u[2] : u[3];
              if constexpr (RT == 2) uu = w0 == 0 ? u[p] : u[2 + p];
              t = sgt::threshold<RULE>(uu, nib_s[c]);
            }
            const float sf = so[c] * f[c];
            if (sf < t) {
              so[c] = -so[c];
              de_acc[c] += 2.f * sf;
              cnt_acc[c] += 1;
              any = true;
            }
          }
        }
      }
      if (any) {
        int8_t b[RT];
#pragma unroll
        for (int c = 0; c < RT; ++c) b[c] = (int8_t)so[c];
        W w;
        memcpy(&w, b, RT);
        *reinterpret_cast<W*>(tile + (size_t)i * RT) = w;
      }
    }
    __syncthreads();  // this colour's flips are visible to the next colour
  }

  // the tile back into the caller's array
  for (int e = tid; e < n_sorted * RT; e += THREADS) {
    const int c = e % RT;
    if (col0 + c < R) spins[(size_t)(e / RT) * R + col0 + c] = (float)tile[e];
  }

  // per-column totals: the lanes of each warp, then the warps in order
#pragma unroll
  for (int c = 0; c < RT; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      de_acc[c] += __shfl_xor_sync(kFull, de_acc[c], off);
      cnt_acc[c] += __shfl_xor_sync(kFull, cnt_acc[c], off);
    }
    if (lane == 0) {
      red_de[warp][c] = de_acc[c];
      red_cnt[warp][c] = cnt_acc[c];
    }
  }
  __syncthreads();
  if (tid < RT && col0 + tid < R) {
    float de = 0.f;
    int cnt = 0;
    for (int w = 0; w < WARPS; ++w) {
      de += red_de[w][tid];
      cnt += red_cnt[w][tid];
    }
    de_out[col0 + tid] = de;
    cnt_out[col0 + tid] = cnt;
  }
}

template <int RT, int RULE, bool HOST_TH>
cudaError_t launch_one(dim3 grid, cudaStream_t stream, const int* idx_t,
                       const float* val_t, const int* deg, const float* h,
                       const float* mask, const int* spans, int n_colors,
                       float* spins, const float* th, const float* beta,
                       uint32_t k0, uint32_t k1,
                       const unsigned long long* seed_ptr, float* de, int* cnt,
                       int n_sorted, int kmax, int R) {
  auto kernel = sparse_sweep_kernel<RT, RULE, HOST_TH>;
  const size_t smem = (size_t)n_sorted * RT;
  static size_t allowed = 48 * 1024;
  const cudaError_t err = sgt::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(idx_t, val_t, deg, h, mask, spans,
                                          n_colors, spins, th, beta, k0, k1,
                                          seed_ptr, de, cnt, n_sorted, kmax,
                                          R);
  return cudaGetLastError();
}

template <int RT>
cudaError_t launch(int rule, bool host_th, dim3 grid, cudaStream_t stream,
                   const int* idx_t, const float* val_t, const int* deg,
                   const float* h, const float* mask, const int* spans,
                   int n_colors, float* spins, const float* th,
                   const float* beta, uint32_t k0, uint32_t k1,
                   const unsigned long long* seed_ptr, float* de, int* cnt,
                   int n_sorted, int kmax, int R) {
#define SGT_K2(RULE, HOST)                                                  \
  return launch_one<RT, RULE, HOST>(                                        \
      grid, stream, idx_t, val_t, deg, h, mask, spans, n_colors, spins, th, \
      beta, k0, k1, seed_ptr, de, cnt, n_sorted, kmax, R)
  if (host_th) {
    if (rule == 0) SGT_K2(0, true); else SGT_K2(1, true);
  } else {
    if (rule == 0) SGT_K2(0, false); else SGT_K2(1, false);
  }
#undef SGT_K2
}

}  // namespace

extern "C" {

// One sweep on `stream`. Returns the launch's CUDA error (0 on success).
// The caller checks shapes: idx_t/val_t [kmax, n_sorted] row-major (the
// tables transposed), deg/h/mask [n_sorted], spans [n_colors + 1] ascending
// within [0, n_sorted], spins (+-1) and th [n_sorted, R] row-major,
// beta/de/cnt [R]; rt in {1, 2, 4, 8}, rule in {0, 1}; the tile's spins,
// n_sorted * rt bytes, must fit the block's shared memory. th == nullptr
// selects the in-kernel Philox stream keyed by `seed`, or by the seed at
// seed_ptr (device memory) where that is not null.
int sgt_sparse_sweep(const int* idx_t, const float* val_t, const int* deg,
                     const float* h, const float* mask, const int* spans,
                     int n_colors, float* spins, const float* th,
                     const float* beta, unsigned long long seed,
                     const unsigned long long* seed_ptr, float* de,
                     int* cnt, int n_sorted, int kmax, int R, int rt, int rule,
                     void* stream) {
  if (R < 1 || n_sorted < 1 || kmax < 1 || n_colors < 0 || rule < 0 ||
      rule > 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + rt - 1) / rt);
  const uint32_t k0 = (uint32_t)(seed & 0xffffffffull);
  const uint32_t k1 = (uint32_t)(seed >> 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool host_th = th != nullptr;
#define SGT_RT(V)                                                          \
  return (int)launch<V>(rule, host_th, grid, s, idx_t, val_t, deg, h, mask, \
                        spans, n_colors, spins, th, beta, k0, k1, seed_ptr, \
                        de, cnt, n_sorted, kmax, R)
  switch (rt) {
    case 1: SGT_RT(1);
    case 2: SGT_RT(2);
    case 4: SGT_RT(4);
    case 8: SGT_RT(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SGT_RT
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
