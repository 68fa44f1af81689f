// The spin-glass overlap of parallel tempering's real replicas, in one
// launch: for every ladder slot t and every pair of chains a < b,
//
//   q_ab(t) = (1/N) sum_i s_i^{x} s_i^{y},  x = the replica of chain a that
//   holds slot t, y = the one of chain b (slot[x] == slot[y] == t),
//
// over the N real spins of a [NS, R] state (int8 or float32, +-1; R = C T,
// replica j of chain j / T). Rows whose mask is negative (the sorted
// layout's padding) are left out. Pairs are in (a, b) lexicographic order;
// out is [T, P] float32, P = C (C - 1) / 2.
//
// No Pallas kernel corresponds: the JAX package measures no overlap. The
// plain PyTorch version is an index of the replicas by slot, a cast, a
// product per pair and a reduction: several launches a measurement inside
// a captured super-step, which a trace cannot tell apart from the PT
// driver's own.
//
// Design. What bounds it is reading the state once (N R bytes of int8: 4.5
// MB at L = 32, R = 136, 1.3 us at 3.35 TB/s). The grid is [row blocks] x
// [slot blocks of up to 256 slots]; a block of 256 threads has G = 256 /
// tb row groups of tb slot threads, so a warp's threads read the C columns
// of their slots in one row: the row's R bytes (two or three lines at R =
// 136) are read by the block once. A thread loads four rows at once (its
// rows' loads do not wait on each other: the first version, a row at a
// time, waited twice a row and took 17.5 us a launch at [32768, 136] on the
// H100, 7.6% of the bound). The chain count C is a runtime bound: the
// loops run to a capacity of CAP chains with C as a guard, so every
// register index is a constant, and a thread keeps the sums of the pairs
// of CAP chains (those of C used) in registers over its rows, as exact
// integers. CAP is 4 up to 4 chains and MAX_CHAINS = 8 above: one capacity
// of 8 took 103 registers a thread and 21.5 us a launch at [32768, 136]
// with 4 chains on the H100, where CAP = 4 takes 58 and 12.9 us. The block
// adds its row groups by shared-memory integer atomics and then adds into
// acc [T, P] by global integer atomics. Integer sums do not depend on their
// order, so the result is exact and deterministic. The last block to finish
// (a ticket) writes q = acc / N, rounded once from double to float32 (exact
// where N is a power of two), and leaves acc and the ticket zeroed for the
// next launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CHAINS = 8;
constexpr int UNROLL = 4;  // rows a thread loads at once

__device__ __forceinline__ int spin_of(int8_t s) { return (int)s; }
__device__ __forceinline__ int spin_of(float s) { return s < 0.f ? -1 : 1; }

// the column of pair (a, b), a < b, among the pairs of n chains
__host__ __device__ constexpr int pair_index(int a, int b, int n) {
  return a * (2 * n - a - 1) / 2 + (b - a - 1);
}

template <typename S, int CAP>
__global__ void __launch_bounds__(THREADS)
replica_overlap_kernel(const S* __restrict__ spins,    // [NS, R]
                       const float* __restrict__ mask, // [NS] 0 / -inf
                       const int* __restrict__ slot,   // [R]
                       int ns, int R, int C, int tb, int rows_per_block,
                       int* acc,                       // [T, P], zero
                       unsigned int* ticket,           // [1], zero
                       float* out,                     // [T, P]
                       int n_real) {
  const int T = R / C;
  const int P = C * (C - 1) / 2;
  extern __shared__ int smem[];
  int* cols = smem;                 // [C, tb]: the column of (chain, slot)
  int* part = smem + C * tb;        // [tb, P]: the block's sums
  __shared__ bool is_last;
  const int t0 = blockIdx.y * tb;
  const int tn = min(tb, T - t0);
  const int groups = THREADS / tb;
  const int g = threadIdx.x / tb;
  const int tl = threadIdx.x % tb;
  for (int j = threadIdx.x; j < R; j += THREADS) {
    const int t = __ldg(slot + j) - t0;
    if (t >= 0 && t < tn) cols[(j / T) * tb + t] = j;
  }
  for (int k = threadIdx.x; k < tn * P; k += THREADS) part[k] = 0;
  __syncthreads();
  if (g < groups && tl < tn) {
    constexpr int CAP_PAIRS = CAP * (CAP - 1) / 2;
    int col[CAP];
#pragma unroll
    for (int c = 0; c < CAP; ++c) col[c] = c < C ? cols[c * tb + tl] : 0;
    int sum[CAP_PAIRS];
#pragma unroll
    for (int k = 0; k < CAP_PAIRS; ++k) sum[k] = 0;
    const int r_hi = min(ns, (blockIdx.x + 1) * rows_per_block);
    // UNROLL rows at a time: their masks and spins are loaded together, so
    // a thread waits for memory once per UNROLL rows, not twice per row
    for (int base = blockIdx.x * rows_per_block + g; base < r_hi;
         base += UNROLL * groups) {
      bool real[UNROLL];
      int s[UNROLL][CAP];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int row = base + u * groups;
        const bool in = row < r_hi;
        const S* p = spins + (size_t)(in ? row : base) * R;
        real[u] = in && __ldg(mask + (in ? row : base)) >= 0.f;
#pragma unroll
        for (int c = 0; c < CAP; ++c)
          s[u][c] = c < C ? spin_of(p[col[c]]) : 0;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!real[u]) continue;
#pragma unroll
        for (int a = 0; a < CAP; ++a)
#pragma unroll
          for (int b = a + 1; b < CAP; ++b)
            if (b < C) sum[pair_index(a, b, CAP)] += s[u][a] * s[u][b];
      }
    }
#pragma unroll
    for (int a = 0; a < CAP; ++a)
#pragma unroll
      for (int b = a + 1; b < CAP; ++b) {
        const int v = sum[pair_index(a, b, CAP)];
        if (b < C && v != 0) atomicAdd(part + tl * P + pair_index(a, b, C), v);
      }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < tn * P; k += THREADS)
    if (part[k] != 0) atomicAdd(acc + (size_t)t0 * P + k, part[k]);
  // the last block to finish writes q and zeroes acc and the ticket
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int k = threadIdx.x; k < T * P; k += THREADS)
    out[k] = (float)((double)atomicExch(acc + k, 0) / (double)n_real);
  if (threadIdx.x == 0) *ticket = 0u;
}

template <typename S>
void launch(dim3 grid, size_t smem, cudaStream_t stream, const S* spins,
            const float* mask, const int* slot, int ns, int R, int C, int tb,
            int rows_per_block, int* acc, unsigned int* ticket, float* out,
            int n_real) {
  if (C <= 4)
    replica_overlap_kernel<S, 4><<<grid, THREADS, smem, stream>>>(
        spins, mask, slot, ns, R, C, tb, rows_per_block, acc, ticket, out,
        n_real);
  else
    replica_overlap_kernel<S, MAX_CHAINS><<<grid, THREADS, smem, stream>>>(
        spins, mask, slot, ns, R, C, tb, rows_per_block, acc, ticket, out,
        n_real);
}

}  // namespace

extern "C" {

// The overlaps of `chains` chains of R / chains replicas each on `stream`:
// spins [ns, R] int8 (spin_bytes 1) or float32 (spin_bytes 4), mask [ns]
// (negative: a row left out), slot [R] int32 (a permutation of 0 .. T-1 in
// each chain), out [T, P] float32 = sums / n_real. acc [T, P] int32 and
// ticket [1] are zeroed before the first launch and left zeroed by each.
// rows_per_block >= 1. Returns cudaGetLastError() after the launch.
int sgt_replica_overlap(const void* spins, int spin_bytes, const float* mask,
                        const int* slot, int ns, int R, int chains,
                        int rows_per_block, int* acc, unsigned int* ticket,
                        float* out, int n_real, void* stream) {
  if (chains < 2 || chains > MAX_CHAINS || R < chains || R % chains != 0 ||
      ns < 1 || rows_per_block < 1 || n_real < 1 ||
      (spin_bytes != 1 && spin_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const int T = R / chains;
  const int P = chains * (chains - 1) / 2;
  const int tb = T < THREADS ? T : THREADS;
  const dim3 grid((ns + rows_per_block - 1) / rows_per_block,
                  (T + tb - 1) / tb);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)(chains + P) * tb;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (spin_bytes == 1)
    launch(grid, smem, s, static_cast<const int8_t*>(spins), mask, slot, ns,
           R, chains, tb, rows_per_block, acc, ticket, out, n_real);
  else
    launch(grid, smem, s, static_cast<const float*>(spins), mask, slot, ns,
           R, chains, tb, rows_per_block, acc, ticket, out, n_real);
  return (int)cudaGetLastError();
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
