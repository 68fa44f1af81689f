// K2 on Hopper: one whole colour-sorted sparse Metropolis/Glauber sweep.
//
// Replaces the Pallas TPU kernel spinglass_tpu/kernels/sparse.py
// (make_single_sweep_call, tables from build_single_tables, driven by
// SortedSparseTEngine._sweep_single). Spins are [NS, R] float32 in the
// colour-sorted layout of build_sorted_t: the rows of colour c are the
// contiguous span [spans[c], spans[c+1]), and no two rows of one colour are
// coupled. For every replica column it makes exactly the decisions of the
// per-colour sweep (kernels/sparse.py:make_sorted_t_sweep):
//
//   for each colour c, in order, all rows i of c from the same spin state:
//     f_i  = h_i + sum_{k < deg_i} val[i, k] * s[idx[i, k]]
//     accept  <=>  s_i * f_i < th_i          (th = -inf on padding rows)
//     accepted: s_i = -s_i ;  dE += 2 s_i f_i ;  count += 1
//
// Design. The TPU grid runs the 32-row steps in order over one VMEM spin
// buffer. CUDA thread blocks run in no order, but replica columns never
// interact, so ONE thread block owns a tile of RT replica columns for the
// whole sweep and walks the colours itself: the rows of a colour are spread
// over its threads (RT lanes per row, 1024 / RT rows at a time) and a
// __syncthreads() separates colours. Nothing passes between thread blocks,
// so there is no grid-wide sync and one launch per sweep. RT is chosen by
// the wrapper (sparse_cuda.default_tile, measured): R=1024 takes RT=8 (128
// blocks), R=128 RT=2 (64 blocks; RT=1 reads 4 useful bytes per 32-byte
// sector and was slower). Each row loops to its own degree (the TPU
// kernel's per-step slot bound `ks` and its unrolled slots are not needed).
//
// What bounds it on the H100: the gathers. Spins stay in the caller's array
// (42 MB at [10240, 1024], held in the 50 MB L2); each row reads deg_i
// neighbour rows of RT floats (32 B at RT=8: one L2 sector), so a sweep
// reads NS * avg_deg * R * 4 bytes (~250 MB at the bench shape) from L2,
// with long chains of dependent L2 round trips (idx -> spins) per thread.
// 32 warps per SM hide part of that latency. The idx/val/deg/h tables
// (~1.6 MB) are read by every block through the read-only path.
//
// Randomness. th == nullptr selects the in-kernel Philox4x32-10 stream keyed
// by the 64-bit sweep seed with counter (sorted row, replica) (philox.cuh),
// the stream of K3 (sparse_thresholds.cu) and of
// kernels/metropolis_cuda.py:philox_uniforms; mask[i] < 0 marks padding
// rows, whose threshold is -inf. Otherwise th is the caller's [NS, R]
// threshold array, already masked.
//
// Bookkeeping. dE and the count are summed per thread, then across the
// threads of a column in a fixed order (warp shuffles, then warps in
// order), so runs are deterministic. Exact float32 throughout; on +-J
// couplings with h on a dyadic grid every field and dE is exact, and the
// kernel equals its twin (kernels/sparse_cuda.py) bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr unsigned kFull = 0xffffffffu;

template <int RT, int RULE, bool HOST_TH>
__global__ void __launch_bounds__(THREADS, 1)
sparse_sweep_kernel(const int* __restrict__ idx,     // [NS, kmax]
                    const float* __restrict__ val,   // [NS, kmax]
                    const int* __restrict__ deg,     // [NS]
                    const float* __restrict__ h,     // [NS]
                    const float* __restrict__ mask,  // [NS] 0 / -inf
                    const int* __restrict__ spans,   // [n_colors + 1]
                    int n_colors,
                    float* spins,                    // [NS, R], in place
                    const float* __restrict__ th,    // [NS, R] or nullptr
                    const float* __restrict__ beta,  // [R]
                    uint32_t k0, uint32_t k1,
                    float* __restrict__ de_out, int* __restrict__ cnt_out,
                    int kmax, int R) {
  constexpr int GROUPS = THREADS / RT;  // rows handled at a time
  __shared__ float red_de[WARPS][32];
  __shared__ int red_cnt[WARPS][32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = tid % RT;
  const int g = tid / RT;
  const int col = blockIdx.x * RT + c;
  const bool live = col < R;
  const float nib = (!HOST_TH && live) ? -0.5f / beta[col] : 0.f;
  float de_acc = 0.f;
  int cnt_acc = 0;

  for (int color = 0; color < n_colors; ++color) {
    const int lo = __ldg(spans + color), hi = __ldg(spans + color + 1);
    if (live) {
      for (int i = lo + g; i < hi; i += GROUPS) {
        const int d = __ldg(deg + i);
        const int* ip = idx + (size_t)i * kmax;
        const float* vp = val + (size_t)i * kmax;
        float f = __ldg(h + i);
        for (int k = 0; k < d; ++k)
          f += __ldg(vp + k) * spins[(size_t)__ldg(ip + k) * R + col];
        const size_t e = (size_t)i * R + col;
        float t;
        if (HOST_TH) {
          t = __ldg(th + e);
        } else {
          t = __ldg(mask + i) < 0.f
                  ? -INFINITY
                  : sgt::threshold<RULE>(
                        sgt::philox_uniform((uint32_t)i, (uint32_t)col, k0, k1),
                        nib);
        }
        const float s = spins[e];
        const float sf = s * f;
        if (sf < t) {
          spins[e] = -s;
          de_acc += 2.f * sf;
          cnt_acc += 1;
        }
      }
    }
    __syncthreads();  // this colour's flips are visible to the next colour
  }

  // per-column totals: lanes of one warp that share a column, then warps
#pragma unroll
  for (int off = 16; off >= RT; off >>= 1) {
    de_acc += __shfl_xor_sync(kFull, de_acc, off);
    cnt_acc += __shfl_xor_sync(kFull, cnt_acc, off);
  }
  if (lane < RT) {
    red_de[warp][lane] = de_acc;
    red_cnt[warp][lane] = cnt_acc;
  }
  __syncthreads();
  if (tid < RT && live) {
    float de = 0.f;
    int cnt = 0;
    for (int w = 0; w < WARPS; ++w) {
      de += red_de[w][tid];
      cnt += red_cnt[w][tid];
    }
    de_out[col] = de;
    cnt_out[col] = cnt;
  }
}

template <int RT>
void launch(int rule, bool host_th, dim3 grid, cudaStream_t stream,
            const int* idx, const float* val, const int* deg, const float* h,
            const float* mask, const int* spans, int n_colors, float* spins,
            const float* th, const float* beta, uint32_t k0, uint32_t k1,
            float* de, int* cnt, int kmax, int R) {
#define SGT_K2(RULE, HOST)                                                   \
  sparse_sweep_kernel<RT, RULE, HOST><<<grid, THREADS, 0, stream>>>(         \
      idx, val, deg, h, mask, spans, n_colors, spins, th, beta, k0, k1, de, \
      cnt, kmax, R)
  if (host_th) {
    if (rule == 0) SGT_K2(0, true); else SGT_K2(1, true);
  } else {
    if (rule == 0) SGT_K2(0, false); else SGT_K2(1, false);
  }
#undef SGT_K2
}

}  // namespace

extern "C" {

// One sweep on `stream`. Returns cudaGetLastError() after the launch (0 on
// success). The caller checks shapes: idx/val [n_sorted, kmax] row-major,
// deg/h/mask [n_sorted], spans [n_colors + 1] ascending within
// [0, n_sorted], spins and th [n_sorted, R] row-major, beta/de/cnt [R];
// rt in {1, 2, 4, 8, 16, 32}, rule in {0, 1}. th == nullptr selects the
// in-kernel Philox stream keyed by `seed`.
int sgt_sparse_sweep(const int* idx, const float* val, const int* deg,
                     const float* h, const float* mask, const int* spans,
                     int n_colors, float* spins, const float* th,
                     const float* beta, unsigned long long seed, float* de,
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
#define SGT_RT(V)                                                            \
  launch<V>(rule, host_th, grid, s, idx, val, deg, h, mask, spans, n_colors, \
            spins, th, beta, k0, k1, de, cnt, kmax, R)
  switch (rt) {
    case 1: SGT_RT(1); break;
    case 2: SGT_RT(2); break;
    case 4: SGT_RT(4); break;
    case 8: SGT_RT(8); break;
    case 16: SGT_RT(16); break;
    case 32: SGT_RT(32); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SGT_RT
  return (int)cudaGetLastError();
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
