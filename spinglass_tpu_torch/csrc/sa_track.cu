// The SA driver's best tracking after a sweep, in one launch. For every
// replica r, from the sweep's energy change de[r] and acceptance count
// cnt[r]:
//
//   e = energy[r] + de[r]                 (float32, rounded once)
//   improved = e < best_energy[r]         (strict: a tie is not improved)
//   energy_out[r] = e
//   best_energy_out[r] = improved ? e : best_energy[r]
//   acc_out[r] = (float)cnt[r] * inv_n    (inv_n = 1.0f / n in float32)
//   copies[r] += improved
//   and, where improved, replica r's spins copied into best in place.
//
// These are the six PyTorch ops that anneal/sa.py ran after each sweep
// (kernels/track_cuda.py: track_reference), bit for bit on the card: acc_out
// is PyTorch's CUDA division by a host scalar, a product with the float32
// reciprocal, not a true division. The best spins are int8 (+-1 exact)
// whatever the spins' type (float32 or int8).
//
// No Pallas kernel corresponds: the JAX package tracks the best inside its
// jitted scan (spinglass_tpu/anneal/sa.py, _one_sweep), where XLA fuses it.
// In the port the six ops were six launches a sweep, and the broadcast
// torch.where over every spin read spins and best spins and wrote a new
// array: 3 rows R 4 bytes a sweep (126 MB at [10240, 1024] float32).
//
// Bound: bytes. The [R] vectors (energy, de, best, cnt and copies read;
// energy, best, acc and copies written: 36 R bytes) and the improved
// replicas' spins read once and their int8 best written once: rows R (b +
// 1) share bytes (b the spin's bytes, share the fraction of replicas
// improved) at 3.35 TB/s. At [10240, 1024] float32 and a share of 0.22:
// 11.6 MB, 3.5 us.
//
// Design. A non-improved replica's spins are not read. The card moves
// whole 32-byte sectors and replicas lie side by side in them ("nr"), so a
// sector is read if any of its replicas improved (at a share of 0.22, 86%
// of the float32 spins' sectors), and a partly written sector costs a read
// of the rest. The first design kept the best spins in the spins' type and
// stored only the improved elements: at [10240, 1024] float32 it took 56
// us a launch at a share of 0.25 (read spins, read and write best, all by
// sectors: no faster than the torch.where) and 49 us a sweep over a
// planted10k job (H100, 700 W). int8 best spins take a quarter of those
// bytes, and a best sector holds 32 replicas. Layout "nr" ([rows, R], R
// contiguous): a thread owns G replicas (16 bytes of float32 or int8
// spins, G bytes of best) in the rows of its block, computes their flags
// once, and for any improved reads its spins and its best vector (unless
// all G improved), sets the improved ones and writes the whole vector; it
// loads UNROLL rows before it stores them. Layout "rn" ([R, n], a
// replica's row contiguous): a block owns a chunk of one replica's row and
// returns at once if that replica did not improve. G is the widest that
// the row's length and both pointers allow.
//
// No race on the [R] state: every block computes improved from the inputs,
// which no block writes; the [R] outputs are other tensors, written once
// per replica, by the first row tile's threads of row 0 ("nr") or by the
// first chunk's thread 0 ("rn").

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;             // rows ("nr") or vectors ("rn") in flight
constexpr int TARGET_BLOCKS = 1056;   // eight blocks per SM of the H100's 132

struct Track {   // the [R] state of a sweep
  const float* energy;
  const float* de;
  const float* best;
  const int* cnt;
  float* energy_out;
  float* best_out;
  float* acc_out;
  int* copies;
  float inv_n;
};

__device__ __forceinline__ bool improved_at(const Track& t, int r) {
  return __fadd_rn(__ldg(t.energy + r), __ldg(t.de + r)) < __ldg(t.best + r);
}

// replica r's [R] outputs; returns whether it improved
__device__ __forceinline__ bool track_replica(const Track& t, int r) {
  const float e = __fadd_rn(__ldg(t.energy + r), __ldg(t.de + r));
  const float b = __ldg(t.best + r);
  const bool improved = e < b;
  t.energy_out[r] = e;
  t.best_out[r] = improved ? e : b;
  t.acc_out[r] = __fmul_rn(__int2float_rn(__ldg(t.cnt + r)), t.inv_n);
  if (improved) t.copies[r] += 1;
  return improved;
}

// a vector type of BYTES bytes
template <int BYTES> struct Bytes;
template <> struct Bytes<1> { using T = unsigned char; };
template <> struct Bytes<2> { using T = unsigned short; };
template <> struct Bytes<4> { using T = unsigned int; };
template <> struct Bytes<8> { using T = uint2; };
template <> struct Bytes<16> { using T = uint4; };

// G spins of type S, and G best spins, as one load or store each
template <typename S, int G>
union SpinVec {
  typename Bytes<G * sizeof(S)>::T v;
  S s[G];
};
template <int G>
union BestVec {
  typename Bytes<G>::T v;
  int8_t s[G];
};

__device__ __forceinline__ int8_t best_of(float s) { return s < 0.f ? -1 : 1; }
__device__ __forceinline__ int8_t best_of(int8_t s) { return s; }

// grid (column tiles, row tiles), block (tx, ty): thread (x, y) owns the G
// replicas of vector x of its column tile in rows y, y + ty, ... of its row
// tile
template <typename S, int G>
__global__ void __launch_bounds__(THREADS)
sa_track_nr_kernel(Track t, const S* __restrict__ spins,
                   int8_t* __restrict__ best, int rows, int R,
                   int rows_per_block) {
  using VS = typename Bytes<G * sizeof(S)>::T;
  using VB = typename Bytes<G>::T;
  constexpr unsigned ALL = (1u << G) - 1u;
  const int vecs = R / G;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= vecs) return;
  const bool writer = blockIdx.y == 0 && threadIdx.y == 0;
  unsigned mask = 0;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const bool imp = writer ? track_replica(t, col * G + k)
                            : improved_at(t, col * G + k);
    mask |= (unsigned)imp << k;
  }
  if (mask == 0) return;
  const VS* src = reinterpret_cast<const VS*>(spins) + col;
  VB* dst = reinterpret_cast<VB*>(best) + col;
  const int hi = min(rows, (int)(blockIdx.y + 1) * rows_per_block);
  const int step = blockDim.y;
  for (int row = blockIdx.y * rows_per_block + threadIdx.y; row < hi;
       row += UNROLL * step) {
    SpinVec<S, G> p[UNROLL];
    BestVec<G> q[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = row + u * step;
      if (rr < hi) {
        p[u].v = src[(size_t)rr * vecs];
        q[u].v = mask == ALL ? VB() : dst[(size_t)rr * vecs];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = row + u * step;
      if (rr >= hi) continue;
#pragma unroll
      for (int k = 0; k < G; ++k)
        if ((mask >> k) & 1u) q[u].s[k] = best_of(p[u].s[k]);
      dst[(size_t)rr * vecs] = q[u].v;
    }
  }
}

// grid (chunks of a row, R): block (x, r) copies chunk x of replica r's row
// of n spins if r improved
template <typename S, int G>
__global__ void __launch_bounds__(THREADS)
sa_track_rn_kernel(Track t, const S* __restrict__ spins,
                   int8_t* __restrict__ best, int n, int chunk) {
  using VS = typename Bytes<G * sizeof(S)>::T;
  using VB = typename Bytes<G>::T;
  const int r = blockIdx.y;
  const bool improved = blockIdx.x == 0 && threadIdx.x == 0
                            ? track_replica(t, r)
                            : improved_at(t, r);
  if (!improved) return;
  const int vecs = n / G;
  const VS* src = reinterpret_cast<const VS*>(spins + (size_t)r * n);
  VB* dst = reinterpret_cast<VB*>(best + (size_t)r * n);
  const int hi = min(vecs, (int)(blockIdx.x + 1) * chunk);
  for (int i = blockIdx.x * chunk + threadIdx.x; i < hi;
       i += UNROLL * THREADS) {
    SpinVec<S, G> p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i + u * THREADS < hi) p[u].v = src[i + u * THREADS];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i + u * THREADS >= hi) continue;
      BestVec<G> q;
#pragma unroll
      for (int k = 0; k < G; ++k) q.s[k] = best_of(p[u].s[k]);
      dst[i + u * THREADS] = q.v;
    }
  }
}

template <typename S, int G>
int launch(const Track& t, const void* spins, void* best, bool nr, int rows,
           int R, cudaStream_t stream) {
  const S* s = static_cast<const S*>(spins);
  int8_t* b = static_cast<int8_t*>(best);
  if (nr) {
    const int vecs = R / G;
    const int tx = vecs < THREADS ? vecs : THREADS;
    const int ty = THREADS / tx;
    const int gx = (vecs + tx - 1) / tx;
    // enough row tiles for TARGET_BLOCKS blocks, each a whole number of
    // UNROLL-row loads of its ty row groups
    const int quantum = ty * UNROLL;
    int rpb = (int)(((long long)rows * gx + TARGET_BLOCKS - 1) / TARGET_BLOCKS);
    rpb = (rpb + quantum - 1) / quantum * quantum;
    const int gy = (rows + rpb - 1) / rpb;
    if (gy > 65535) return (int)cudaErrorInvalidValue;
    sa_track_nr_kernel<S, G><<<dim3(gx, gy), dim3(tx, ty), 0, stream>>>(
        t, s, b, rows, R, rpb);
  } else {
    const int chunk = THREADS * UNROLL;
    const int gx = (rows / G + chunk - 1) / chunk;
    if (R > 65535) return (int)cudaErrorInvalidValue;
    sa_track_rn_kernel<S, G><<<dim3(gx, R), THREADS, 0, stream>>>(
        t, s, b, rows, chunk);
  }
  return (int)cudaGetLastError();
}

// G: the most spins (16 bytes of them at most) that divide the contiguous
// row and that both pointers' alignment allows
template <typename S>
int dispatch(const Track& t, const void* spins, void* best, bool nr,
             int rows, int R, cudaStream_t stream) {
  const unsigned long long row = (unsigned long long)(nr ? R : rows);
  int g = 16 / (int)sizeof(S);
  while (g > 1 && (row % g != 0 || (uintptr_t)spins % (g * sizeof(S)) != 0
                   || (uintptr_t)best % g != 0))
    g /= 2;
  switch (g) {
    case 16:
      if constexpr (sizeof(S) == 1)
        return launch<S, 16>(t, spins, best, nr, rows, R, stream);
      break;
    case 8:
      if constexpr (sizeof(S) <= 2)
        return launch<S, 8>(t, spins, best, nr, rows, R, stream);
      break;
    case 4:
      return launch<S, 4>(t, spins, best, nr, rows, R, stream);
    case 2:
      return launch<S, 2>(t, spins, best, nr, rows, R, stream);
    default:
      return launch<S, 1>(t, spins, best, nr, rows, R, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One sweep's best tracking on `stream` for R replicas: energy, de,
// best_energy [R] float32 and cnt [R] int32 read; energy_out, best_out,
// acc_out [R] float32 written (other tensors than the inputs); copies [R]
// int32 incremented where improved; spins (spin_bytes 4: float32, 1: int8)
// and best (int8) [rows, R] (nr = 1) or [R, rows] (nr = 0), contiguous,
// best updated in place for the improved replicas. inv_n is 1.0f / n in
// float32. Returns cudaGetLastError() after the launch.
int sgt_sa_track(const float* energy, const float* de,
                 const float* best_energy, const int* cnt, float inv_n,
                 float* energy_out, float* best_out, float* acc_out,
                 int* copies, const void* spins, void* best, int spin_bytes,
                 int nr, int rows, int R, void* stream) {
  if (rows < 1 || R < 1 || (spin_bytes != 1 && spin_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const Track t{energy, de, best_energy, cnt, energy_out, best_out,
                acc_out, copies, inv_n};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (spin_bytes == 1)
    return dispatch<int8_t>(t, spins, best, nr != 0, rows, R, s);
  return dispatch<float>(t, spins, best, nr != 0, rows, R, s);
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
