// C1 on Hopper: the connected-component labels of one Swendsen-Wang sweep.
//
// No Pallas kernel of the JAX package stands behind this one. The JAX
// SwendsenWang (spinglass_tpu/core/cluster.py:291) labels clusters with a
// lax.while_loop: min-label propagation over the active bonds with pointer
// jumping, until no label changes (at most n_pad rounds). The port runs
// that sweep inside a captured PT super-step (anneal/graphs.py), which
// cannot branch on the host: a host check per round would make a replay
// wait for the card, and a fixed number of rounds is not sure to converge.
// So the loop runs to its fixed point inside one launch:
//
//   one thread block per replica; its labels l [n] (int32) in shared memory
//   where n * 4 bytes fit (SHARED), else in the output array itself. Each
//   round every thread takes its sites i (strided by the block size):
//       m = min(l[i], min over bonded slots q of l[idx[i, q]])
//       if m >= 0: m = min(m, l[min(m, n - 1)])      (pointer jumping)
//       if m < l[i]: l[i] = m
//   and the block ORs "something changed" through __syncthreads_or.
//
// Why the labels equal the JAX loop's, although the updates land in place
// and in no fixed order: only the owner of site i writes l[i], and only
// lower values, and every value a site reads is the label of a site in the
// same cluster (or -1, a cluster bonded to the ghost spin). The bonds are
// symmetric (one uniform per undirected edge), so a round in which nothing
// changes is a fixed point where each cluster holds one label, and that
// label is the least initial label in the cluster: -1 if a site of it is
// ghost-bonded, else its smallest site index. Inactive sites start at n and
// jump to l[n - 1] as the JAX gather clamps its index. In-place rounds take
// no more rounds than the JAX loop's (Jacobi) rounds from the same start;
// the cap is n rounds, as there. The rounds a replica took go to rounds[r].
//
// What bounds it on the H100: the bond flags, R * n * K bytes, read once
// per round (the neighbour indices, n * K * 4 bytes, are shared by the
// replicas through L2), and rounds * n * (K + 2) compare-and-select
// operations per replica. One block per replica keeps the loop free of a
// grid-wide barrier; at 16 replicas that leaves most SMs idle, which the
// first version accepts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;

template <bool SHARED>
__global__ void __launch_bounds__(THREADS)
sw_labels_kernel(const int* __restrict__ idx,       // [n, K] neighbour sites
                 const uint8_t* __restrict__ bond,  // [R, n, K] 0 / 1
                 const int* __restrict__ init,      // [R, n] start labels
                 int* __restrict__ labels,          // [R, n] out
                 int* __restrict__ rounds,          // [R] out
                 int n, int k) {
  extern __shared__ int smem[];
  const int r = blockIdx.x;
  int* out = labels + (size_t)r * n;
  int* l = SHARED ? smem : out;
  const int* in = init + (size_t)r * n;
  const uint8_t* b = bond + (size_t)r * n * k;
  for (int i = threadIdx.x; i < n; i += THREADS) l[i] = in[i];
  __syncthreads();
  int it = 0, changed = 1;
  while (changed && it < n) {
    int mine = 0;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int cur = l[i];
      int m = cur;
      const uint8_t* bi = b + (size_t)i * k;
      const int* ii = idx + (size_t)i * k;
      for (int q = 0; q < k; ++q) {
        if (bi[q]) {
          const int v = l[__ldg(ii + q)];
          m = v < m ? v : m;
        }
      }
      if (m >= 0) {
        const int v = l[m < n ? m : n - 1];
        m = v < m ? v : m;
      }
      if (m < cur) {
        l[i] = m;
        mine = 1;
      }
    }
    changed = __syncthreads_or(mine);
    ++it;
  }
  if (SHARED)
    for (int i = threadIdx.x; i < n; i += THREADS) out[i] = l[i];
  if (threadIdx.x == 0) rounds[r] = it;
}

size_t g_allowed_smem = 48 * 1024;  // the default dynamic limit

}  // namespace

extern "C" {

// Largest n whose labels the kernel keeps in shared memory.
int sgt_sw_labels_max_shared_sites() { return (200 * 1024) / 4; }

// Labels [R, n] and rounds [R] from idx [n, K], bond [R, n, K] (bytes 0 /
// 1) and the start labels init [R, n], on `stream`. Returns
// cudaGetLastError() after the launch (0 on success).
int sgt_sw_labels(const int* idx, const uint8_t* bond, const int* init,
                  int* labels, int* rounds, int n, int k, int R,
                  void* stream) {
  if (n < 1 || k < 1 || R < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)n * sizeof(int);
  if (n <= sgt_sw_labels_max_shared_sites()) {
    if (smem > g_allowed_smem) {
      const cudaError_t err = cudaFuncSetAttribute(
          sw_labels_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
      g_allowed_smem = smem;
    }
    sw_labels_kernel<true><<<R, THREADS, smem, s>>>(idx, bond, init, labels,
                                                    rounds, n, k);
  } else {
    sw_labels_kernel<false><<<R, THREADS, 0, s>>>(idx, bond, init, labels,
                                                  rounds, n, k);
  }
  return (int)cudaGetLastError();
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
