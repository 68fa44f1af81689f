// K4 on Hopper: one colour of the colour-sorted sparse sweep in one launch:
// fields, thresholds, accept, flip, dE and counts.
//
// Replaces the Pallas TPU kernel spinglass_tpu/kernels/sparse.py
// (make_accept_call) together with the per-colour field gathers that
// make_sorted_t_sweep_fused left to XLA around it. For the colour's rows
// off .. off+mc-1 of the [NS, R] layout and every replica column r:
//
//   f  = h[row] + sum_{k < deg[row]} val[row, k] * s[idx[row, k], r]  (k order)
//   th = mask[row] < 0 ? -inf : threshold(u(row, r), -0.5 / beta[r])
//   accept  <=>  s * f < th ;  s -> -s on accept
//   dE[r] += 2 * sum of s * f over accepted rows ;  count[r] += accepted
//
// Two field modes in one template. f == nullptr (gather mode, what
// make_sorted_t_sweep_fused launches): the kernel reads K2's slot tables idx /
// val [NS, kmax], deg and h, and gathers the neighbours' spins from the
// [NS, R] array itself, summing slots in K2's order. A colour
// is an independent set: no row of it is a neighbour of another, so the rows
// a block reads are never the rows another block of this launch flips (slots
// past a row's degree are not read). f != nullptr: the fields [mc, R] come
// from the caller, which is make_accept_call's signature.
// u is the sparse kernels' Philox4x32-10 stream (philox.cuh,
// philox_uniform4: counter (sorted row, replica >> 2), four uniforms per run
// of the rounds), so under one seed the K4 path, K2 and the K3 path make the
// same decisions.
//
// What bounds it on the H100, and the design. Over one sweep at [10240, 4096]
// with int8 spins the least work is reading and writing the spins once, 84
// MB and the 1.5 MB of tables (26 us at 3.35 TB/s); the gathers re-read
// ~6 neighbour rows per row, 252 MB, which the 50 MB L2 can mostly serve
// (the whole spin array is 42 MB). The first version took its fields from
// PyTorch gathers (~280 launches and ~2.2 ms a sweep at that shape, f
// written and read back as 168 MB of float32) and ran one block per 32
// columns (128 blocks at R = 4096, 4 at R = 128): 356-365 us a sweep for the
// accept alone. Now:
//   - a thread owns one row and four consecutive columns: one char4 (or
//     float4) load per neighbour, one run of the Philox rounds per row; a
//     warp covers 128 columns of a row (128 bytes of int8: one line);
//   - a row's latency is what a sweep costs (a warp has one row in flight),
//     so a row waits for memory once, not once per table entry: its own
//     spins, mask, degree, h and slot table (lane k reads slot k, one
//     coalesced read of the row-major table) are fetched one row ahead; the
//     slots are handed round by shuffles and up to 8 gathers (4 with
//     float32 spins) are issued together; the Philox rounds and the four
//     logarithms, which need no memory, run while the gathers and the next
//     row's inputs are in flight. The version that walked mask -> degree ->
//     4 slots -> 4 gathers -> 4 slots -> ... -> Philox took 300 us a sweep
//     at [10240, 4096] int8;
//   - the grid is [column blocks of 128] x [row blocks of the colour], the
//     rows per block chosen by the wrapper so that a colour of ~1460 rows
//     fills the card at R = 128 as at R = 4096;
//   - dE and counts without float atomics: each block sums its rows per
//     column (threads, then its 8 warps in order) into scratch [row blocks,
//     R]; the last block of a column block to finish (a ticket counter per
//     column block, reset by that block) adds the partial sums into de /
//     cnt, its warp w taking row blocks w, w + 8, ... in order and the eight
//     warps' sums then added in warp order. The order is fixed by the
//     shapes, so runs are deterministic, and the colours' launches on one
//     stream add in colour order.
// Any NS and R that fit device memory; no shared-memory tile. Where R is no
// multiple of 4 the rows are not aligned for vector access and the four
// columns are loaded and stored one by one.
// Measured on the H100 (700 W), one sweep of the 10k bench graph (7 colours):
// 279-289 us at [10240, 4096] int8 (460-510 with float32 spins), ~100 at
// [10240, 1024], 60-70 at [10240, 128] and [10240, 16]; on given fields
// 174-182 us at [10240, 4096] against the first version's 337. The fused
// sweep before it (PyTorch gathers and the first K4) took 4300-5100 us at
// [10240, 4096] in the same call. That is 10% of the rate the bound allows
// (29 us: the thresholds' operations, then 86 MB). Scratch builds that left
// parts out took 238 us without the Philox rounds, 250 without the gathers
// and 216 without both, of 284: no part dominates, a row is ~470
// instructions per thread and a warp has one row in flight.
//
// Spins are int8 (the fused engine's default) or float32, and +-1: the
// kernel uses only their sign bits (val * s is val with s's sign), which is
// the float32 arithmetic of the Pallas kernel without a conversion per spin.
// Adding val * s to f in k order rounds as K2's fmaf(val, s, f) does, so on
// any couplings the decisions equal those of the slot-ordered plain version.
// Exact float32, no --use_fast_math (philox.cuh).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int COLS = 128;  // replica columns per thread block: 4 per lane
constexpr unsigned kFull = 0xffffffffu;

constexpr uint32_t kSign = 0x80000000u;

// Four consecutive spins of a row as they were loaded (one vector load where
// VEC), so that a batch of gathers is issued before the first is used.
// Spins are +-1, so all the arithmetic needs of one is its sign bit:
// v * s is v with its sign flipped where s < 0, which costs an XOR where a
// conversion from int8 to float would cost a slow-rate instruction per spin.
template <typename S, bool VEC> struct Quad { S v[4]; };
template <> struct Quad<int8_t, true> { uint32_t w; };
template <> struct Quad<float, true> { float4 w; };

template <typename S, bool VEC>
__device__ __forceinline__ void fetch(const S* p, int valid, Quad<S, VEC>& q) {
  if constexpr (VEC) {
    q.w = *reinterpret_cast<const decltype(q.w)*>(p);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) q.v[c] = c < valid ? p[c] : (S)1;
  }
}

// The sign bit of spin c, at bit 31.
template <typename S, bool VEC>
__device__ __forceinline__ uint32_t sign_of(const Quad<S, VEC>& q, int c) {
  if constexpr (VEC && sizeof(S) == 1) {
    return (q.w << (24 - 8 * c)) & kSign;
  } else if constexpr (VEC) {
    const float x = c == 0 ? q.w.x : c == 1 ? q.w.y : c == 2 ? q.w.z : q.w.w;
    return __float_as_uint(x) & kSign;
  } else if constexpr (sizeof(S) == 1) {
    return ((uint32_t)(uint8_t)q.v[c] << 24) & kSign;
  } else {
    return __float_as_uint(q.v[c]) & kSign;
  }
}

// s -> -s for spin c (+1 is 0x01 and -1 is 0xff as int8: XOR with 0xfe).
template <typename S, bool VEC>
__device__ __forceinline__ void flip(Quad<S, VEC>& q, int c) {
  if constexpr (VEC && sizeof(S) == 1) {
    q.w ^= 0xfeu << (8 * c);
  } else if constexpr (VEC) {
    float& x = c == 0 ? q.w.x : c == 1 ? q.w.y : c == 2 ? q.w.z : q.w.w;
    x = -x;
  } else {
    q.v[c] = (S)(-q.v[c]);
  }
}

template <typename S, bool VEC>
__device__ __forceinline__ void put(S* p, int valid, const Quad<S, VEC>& q) {
  if constexpr (VEC) {
    *reinterpret_cast<decltype(Quad<S, VEC>::w)*>(p) = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < valid) p[c] = q.v[c];
  }
}

// Four consecutive fields of a row of f [mc, R].
template <bool VEC>
__device__ __forceinline__ void load_fields(const float* p, int valid,
                                            float (&out)[4]) {
  if constexpr (VEC) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    out[0] = w.x; out[1] = w.y; out[2] = w.z; out[3] = w.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = c < valid ? p[c] : 0.f;
  }
}

__device__ __forceinline__ float with_sign(float v, uint32_t sign) {
  return __uint_as_float(__float_as_uint(v) ^ sign);
}

// RULE 0: metropolis, 1: glauber. GATHER: fields from the tables and the
// spins, else from f. VEC: R % 4 == 0.
template <int RULE, typename S, bool GATHER, bool VEC>
__global__ void __launch_bounds__(THREADS)
sparse_accept_kernel(const float* __restrict__ f,      // [mc, R] (!GATHER)
                     const int* __restrict__ idx,      // [NS, kmax] (GATHER)
                     const float* __restrict__ val,    // [NS, kmax]
                     const int* __restrict__ deg,      // [NS]
                     const float* __restrict__ h,      // [NS]
                     int kmax,
                     S* spins,                         // [NS, R], in place
                     const float* __restrict__ mask,   // [NS] 0 / -inf
                     const float* __restrict__ beta,   // [R]
                     uint32_t k0, uint32_t k1,
                     const unsigned long long* __restrict__ seed_ptr,
                     float* de,                        // [R], accumulated
                     int* cnt,                         // [R], accumulated
                     float* scratch_de,                // [gridDim.y, R]
                     int* scratch_cnt,                 // [gridDim.y, R]
                     unsigned int* tickets,            // [gridDim.x], zero
                     int off, int mc, int R, int rows_per_block,
                     bool accumulate) {  // false: de / cnt are overwritten
  sgt::device_seed(seed_ptr, k0, k1);
  // gathers in flight per thread: 8 char4 or 4 float4
  constexpr int KB = sizeof(S) == 1 ? 8 : 4;
  __shared__ float de_part[WARPS][COLS];
  __shared__ int cnt_part[WARPS][COLS];
  __shared__ bool is_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = blockIdx.x * (COLS / 4) + lane;
  const int valid = R - 4 * group;  // columns of this thread inside the row
  // a lane beyond R follows its warp (the shuffles below need every lane)
  // on column 0 and never stores
  const int col = valid > 0 ? 4 * group : 0;
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
  int n[4] = {0, 0, 0, 0};
  float nib[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    nib[q] = q < valid ? -0.5f / __ldg(beta + col + q) : 0.f;
  const int i_lo = blockIdx.y * rows_per_block;
  const int i_hi = min(mc, i_lo + rows_per_block);
  // What a row needs from memory before its gathers: its own spins, mask,
  // and in gather mode its degree, h and the first 32 slots of its table
  // (lane k holds slot k), else its fields. All of it depends only on the
  // row number, so it is fetched one row ahead.
  struct RowIn {
    Quad<S, VEC> own;
    float mask, hv, v_l, fv[4];
    int d, j_l;
  };
  auto load_row = [&](RowIn& in, int i) {
    const int row = off + i;
    fetch<S, VEC>(spins + (size_t)row * R + col, valid, in.own);
    in.mask = __ldg(mask + row);
    if (GATHER) {
      in.d = __ldg(deg + row);
      in.hv = __ldg(h + row);
      const bool mine = lane < kmax;
      in.j_l = mine ? __ldg(idx + (size_t)row * kmax + lane) : row;
      in.v_l = mine ? __ldg(val + (size_t)row * kmax + lane) : 0.f;
    } else {
      load_fields<VEC>(f + (size_t)i * R + col, valid, in.fv);
    }
  };
  // KB gathers of slots kb .. kb+KB-1, issued together; a slot past the
  // row's degree reads the row itself with coupling 0
  auto gather = [&](Quad<S, VEC> (&nb)[KB], float (&v)[KB], int row, int d,
                    int kb, int j_l, float v_l) {
#pragma unroll
    for (int b = 0; b < KB; ++b) {
      const bool in = kb + b < d;
      const int j = __shfl_sync(kFull, j_l, (kb + b) & 31);
      const float vv = __shfl_sync(kFull, v_l, (kb + b) & 31);
      v[b] = in ? vv : 0.f;
      fetch<S, VEC>(spins + (size_t)(in ? j : row) * R + col, valid, nb[b]);
    }
  };
  // f += val * s in slot order, the product being val with s's sign: what
  // fmaf(val, s, f) rounds to
  auto add = [&](float (&fv)[4], const Quad<S, VEC> (&nb)[KB],
                 const float (&v)[KB]) {
#pragma unroll
    for (int b = 0; b < KB; ++b) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        fv[q] += with_sign(v[b], sign_of<S, VEC>(nb[b], q));
    }
  };
  int i = i_lo + warp;
  RowIn cur;
  if (i < i_hi) load_row(cur, i);
  for (; i < i_hi; i += WARPS) {
    const int row = off + i;
    // 1. the first KB gathers go out
    Quad<S, VEC> nb[KB];
    float v[KB];
    if (GATHER) gather(nb, v, row, cur.d, 0, cur.j_l, cur.v_l);
    // 2. the next row's inputs go out behind them
    RowIn nxt;
    if (i + WARPS < i_hi) load_row(nxt, i + WARPS);
    // 3. the thresholds need no memory: computed while both are in flight
    const bool padded = cur.mask < 0.f;  // never accepts
    float th[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    if (!padded) {
      float u[4];
      sgt::philox_uniform4((uint32_t)row, (uint32_t)group, k0, k1, u);
#pragma unroll
      for (int q = 0; q < 4; ++q) th[q] = sgt::threshold<RULE>(u[q], nib[q]);
    }
    // 4. the fields
    float fv[4];
    if (GATHER) {
#pragma unroll
      for (int q = 0; q < 4; ++q) fv[q] = cur.hv;
      add(fv, nb, v);
      int j_l = cur.j_l;
      float v_l = cur.v_l;
      for (int kb = KB; kb < cur.d; kb += KB) {  // rows of more than KB slots
        if ((kb & 31) == 0) {                    // ... and of more than 32
          const bool mine = kb + lane < kmax;
          j_l = mine ? __ldg(idx + (size_t)row * kmax + kb + lane) : row;
          v_l = mine ? __ldg(val + (size_t)row * kmax + kb + lane) : 0.f;
        }
        gather(nb, v, row, cur.d, kb, j_l, v_l);
        add(fv, nb, v);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) fv[q] = cur.fv[q];
    }
    // 5. accept
    bool any = false;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float sf = with_sign(fv[q], sign_of<S, VEC>(cur.own, q));  // s * f
      if (q < valid && sf < th[q]) {
        flip<S, VEC>(cur.own, q);
        sum[q] += sf;
        n[q] += 1;
        any = true;
      }
    }
    if (any) put<S, VEC>(spins + (size_t)row * R + col, valid, cur.own);
    cur = nxt;
  }
  // the block's rows per column: this thread's, then the warps in order
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    de_part[warp][4 * lane + q] = sum[q];
    cnt_part[warp][4 * lane + q] = n[q];
  }
  __syncthreads();
  const int c = blockIdx.x * COLS + threadIdx.x;
  const bool owner = threadIdx.x < COLS && c < R;
  if (owner) {
    float v = 0.f;
    int m = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      v += de_part[w][threadIdx.x];
      m += cnt_part[w][threadIdx.x];
    }
    if (gridDim.y == 1) {
      de[c] = (accumulate ? de[c] : 0.f) + 2.f * v;
      cnt[c] = (accumulate ? cnt[c] : 0) + m;
    } else {
      scratch_de[(size_t)blockIdx.y * R + c] = v;
      scratch_cnt[(size_t)blockIdx.y * R + c] = m;
    }
  }
  if (gridDim.y == 1) return;
  // the last row block of this column block to finish adds the partial sums
  // in row-block order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(tickets + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // warp w adds row blocks w, w + 8, ... for the lanes' four columns each,
  // then the eight partial sums are added in warp order
  {
    const int c0 = blockIdx.x * COLS + 4 * lane;
    float v4[4] = {0.f, 0.f, 0.f, 0.f};
    int m4[4] = {0, 0, 0, 0};
#pragma unroll 4
    for (unsigned int b = warp; b < gridDim.y; b += WARPS) {
      const float* pd = scratch_de + (size_t)b * R + c0;
      const int* pc = scratch_cnt + (size_t)b * R + c0;
      if constexpr (VEC) {
        if (c0 < R) {
          const float4 x = __ldcg(reinterpret_cast<const float4*>(pd));
          const int4 y = __ldcg(reinterpret_cast<const int4*>(pc));
          v4[0] += x.x; v4[1] += x.y; v4[2] += x.z; v4[3] += x.w;
          m4[0] += y.x; m4[1] += y.y; m4[2] += y.z; m4[3] += y.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c0 + q < R) {
            v4[q] += __ldcg(pd + q);
            m4[q] += __ldcg(pc + q);
          }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      de_part[warp][4 * lane + q] = v4[q];
      cnt_part[warp][4 * lane + q] = m4[q];
    }
  }
  __syncthreads();
  if (owner) {
    float v = 0.f;
    int m = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      v += de_part[w][threadIdx.x];
      m += cnt_part[w][threadIdx.x];
    }
    de[c] = (accumulate ? de[c] : 0.f) + 2.f * v;
    cnt[c] = (accumulate ? cnt[c] : 0) + m;
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;
}

struct Args {
  const float* f;
  const int* idx;
  const float* val;
  const int* deg;
  const float* h;
  int n_sorted, kmax;
  void* spins;
  const float* mask;
  const float* beta;
  uint32_t k0, k1;
  const unsigned long long* seed_ptr;
  float* de;
  int* cnt;
  float* scratch_de;
  int* scratch_cnt;
  unsigned int* tickets;
  int off, mc, R, rows_per_block;
  bool accumulate;
};

template <int RULE, typename S, bool GATHER, bool VEC>
void launch(dim3 grid, cudaStream_t stream, const Args& a) {
  sparse_accept_kernel<RULE, S, GATHER, VEC><<<grid, THREADS, 0, stream>>>(
      a.f, a.idx, a.val, a.deg, a.h, a.kmax, static_cast<S*>(a.spins),
      a.mask, a.beta, a.k0, a.k1, a.seed_ptr, a.de, a.cnt, a.scratch_de,
      a.scratch_cnt, a.tickets, a.off, a.mc, a.R, a.rows_per_block, a.accumulate);
}

template <int RULE, typename S>
void launch_mode(dim3 grid, cudaStream_t stream, const Args& a) {
  const bool vec = a.R % 4 == 0;
  if (a.f == nullptr) {
    if (vec) launch<RULE, S, true, true>(grid, stream, a);
    else launch<RULE, S, true, false>(grid, stream, a);
  } else {
    if (vec) launch<RULE, S, false, true>(grid, stream, a);
    else launch<RULE, S, false, false>(grid, stream, a);
  }
}

// One colour on `stream`; returns cudaGetLastError() after the launch.
int launch_colour(const Args& a, int spin_bytes, int rule,
                  cudaStream_t stream) {
  if (a.R < 1 || a.mc < 1 || a.off < 0 || rule < 0 || rule > 1 ||
      a.rows_per_block < 1 || (spin_bytes != 1 && spin_bytes != 4) ||
      (a.f == nullptr && (a.kmax < 1 || a.n_sorted < a.off + a.mc)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.R + COLS - 1) / COLS,
                  (a.mc + a.rows_per_block - 1) / a.rows_per_block);
  if (grid.y > 65535 ||
      (grid.y > 1 && (!a.scratch_de || !a.scratch_cnt || !a.tickets)))
    return (int)cudaErrorInvalidValue;
  if (spin_bytes == 1) {
    if (rule == 0) launch_mode<0, int8_t>(grid, stream, a);
    else launch_mode<1, int8_t>(grid, stream, a);
  } else {
    if (rule == 0) launch_mode<0, float>(grid, stream, a);
    else launch_mode<1, float>(grid, stream, a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Accept one colour's rows off .. off+mc-1 on `stream`. f [mc, R] float32,
// or nullptr for the gather mode, which reads idx / val [n_sorted, kmax]
// row-major and deg / h [n_sorted]. spins [n_sorted, R] int8 (spin_bytes 1)
// or float32 (spin_bytes 4); mask [n_sorted]; beta [R]; dE and the count are
// added into de, cnt [R]. rows_per_block >= 1 rows of the colour go to one
// thread block; with more than one row block, scratch_de / scratch_cnt hold
// [row blocks, R] and tickets one zeroed counter per block of 128 columns
// (left zeroed). The seed is `seed`, or the one at seed_ptr (device memory)
// where not null. Returns cudaGetLastError() after the launch.
int sgt_sparse_accept(const float* f, const int* idx, const float* val,
                      const int* deg, const float* h, int n_sorted, int kmax,
                      void* spins, int spin_bytes, const float* mask,
                      const float* beta, unsigned long long seed,
                      const unsigned long long* seed_ptr, float* de,
                      int* cnt, float* scratch_de, int* scratch_cnt,
                      unsigned int* tickets, int off, int mc, int R,
                      int rows_per_block, int rule, void* stream) {
  const Args a{f, idx, val, deg, h, n_sorted, kmax, spins, mask, beta,
               (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32),
               seed_ptr, de, cnt, scratch_de, scratch_cnt, tickets, off, mc, R,
               rows_per_block, true};
  return launch_colour(a, spin_bytes, rule,
                       static_cast<cudaStream_t>(stream));
}

// A whole sweep in gather mode: one launch per colour, in order, from one
// call. spans [n_colors + 1] and rows_per_block [n_colors] are host arrays:
// colour c is rows spans[c] .. spans[c+1]-1. The first launch overwrites
// de / cnt [R], the others add, so the caller need not zero them. Returns
// the first launch error (later colours are then not launched).
int sgt_sparse_accept_sweep(const int* idx, const float* val,
                            const int* deg, const float* h, int n_sorted,
                            int kmax, void* spins, int spin_bytes,
                            const float* mask, const float* beta,
                            unsigned long long seed,
                            const unsigned long long* seed_ptr, float* de,
                            int* cnt, float* scratch_de, int* scratch_cnt,
                            unsigned int* tickets, const int* spans,
                            const int* rows_per_block, int n_colors, int R,
                            int rule, void* stream) {
  if (n_colors < 1 || spans[n_colors] <= spans[0])
    return (int)cudaErrorInvalidValue;
  bool first = true;
  for (int c = 0; c < n_colors; ++c) {
    if (spans[c + 1] == spans[c]) continue;  // an empty colour
    const Args a{nullptr, idx, val, deg, h, n_sorted, kmax, spins, mask, beta,
                 (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32),
                 seed_ptr, de, cnt, scratch_de, scratch_cnt, tickets, spans[c],
                 spans[c + 1] - spans[c], R, rows_per_block[c], !first};
    first = false;
    const int err = launch_colour(a, spin_bytes, rule,
                                  static_cast<cudaStream_t>(stream));
    if (err != 0) return err;
  }
  return 0;
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
