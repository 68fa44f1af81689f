// The time-to-target loop's latch, at the end of its captured PT
// super-step. The host queues the next super-step before it reads the
// best energy of the last one, so a super-step may run after the one that
// reached the target; the latch keeps the state as it was at that first
// hit, for the host to copy back:
//
//   hit = flag[0] == 0 && (double)best <= threshold
//   if hit: every leaf of the state copied into its snapshot, flag[0] = 1
//
// best is the super-step's least best energy (float32), threshold a
// float64 device scalar (the host's own comparison, exact), flag [2] int32:
// flag[0] latched, flag[1] the blocks that have finished a hit's copy (0
// between launches). The host zeroes the flag at the start of each solve.
//
// No Pallas kernel corresponds: the JAX package runs the whole solve as one
// lax.while_loop on the device (spinglass_tpu/benchmarks/planted.py), whose
// state is the answer when its condition turns false. A captured graph
// cannot branch, so the port's super-steps run on after the hit and this
// kernel keeps the state at it.
//
// Cost. On every super-step but the hit it reads 16 bytes and returns: a
// launch of BLOCKS blocks that leave at once. On the hit it copies the
// state once (at [10240, 128] float32: spins and best spins 10.5 MB).
//
// No race on the flag: every block decides from flag[0] before any block
// writes it. A block that has copied its share counts itself in flag[1]
// (after a fence); the last of them, which every other block has passed,
// sets flag[0] and zeroes flag[1].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS = 132;        // one block per SM of the H100
constexpr int MAX_LEAVES = 16;

struct Leaves {   // the state's tensors and their snapshots, by value
  const void* src[MAX_LEAVES];
  void* dst[MAX_LEAVES];
  unsigned long long bytes[MAX_LEAVES];
  int n;
};

__global__ void __launch_bounds__(THREADS)
pt_latch_kernel(Leaves leaves, const float* __restrict__ best,
                const double* __restrict__ threshold, int* flag) {
  __shared__ int hit;
  if (threadIdx.x == 0)
    hit = flag[0] == 0 && (double)*best <= *threshold;
  __syncthreads();
  if (!hit) return;
  const size_t first = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * THREADS;
  for (int k = 0; k < leaves.n; ++k) {
    const char* s = static_cast<const char*>(leaves.src[k]);
    char* d = static_cast<char*>(leaves.dst[k]);
    const size_t n = leaves.bytes[k];
    if ((((uintptr_t)s | (uintptr_t)d | n) & 15) == 0) {
      const uint4* s4 = reinterpret_cast<const uint4*>(s);
      uint4* d4 = reinterpret_cast<uint4*>(d);
      for (size_t i = first; i < n / 16; i += stride) d4[i] = s4[i];
    } else {
      for (size_t i = first; i < n; i += stride) d[i] = s[i];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    unsigned* done = reinterpret_cast<unsigned*>(flag + 1);
    if (atomicAdd(done, 1u) == gridDim.x - 1) {
      *done = 0u;
      flag[0] = 1;
    }
  }
}

}  // namespace

extern "C" {

// One latch on `stream`: n (1..16) leaves, src[k] copied into dst[k]
// (bytes[k] bytes each, contiguous) if the flag is clear and best <=
// threshold. Returns cudaGetLastError() after the launch.
int sgt_pt_latch(const float* best, const double* threshold, int* flag,
                 const void* const* src, void* const* dst,
                 const unsigned long long* bytes, int n, void* stream) {
  if (n < 1 || n > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  Leaves leaves{};
  unsigned long long total = 0;
  for (int k = 0; k < n; ++k) {
    leaves.src[k] = src[k];
    leaves.dst[k] = dst[k];
    leaves.bytes[k] = bytes[k];
    total += bytes[k];
  }
  leaves.n = n;
  // no more blocks than a hit's copy has 16-byte words for
  const unsigned long long words = (total + 15) / 16;
  int blocks = BLOCKS;
  if (words < (unsigned long long)BLOCKS * THREADS)
    blocks = words == 0 ? 1 : (int)((words + THREADS - 1) / THREADS);
  pt_latch_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      leaves, best, threshold, flag);
  return (int)cudaGetLastError();
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
