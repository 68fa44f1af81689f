// C1 on Hopper: the cluster labels of one Swendsen-Wang sweep, and the
// cluster flips, in one launch.
//
// No Pallas kernel of the JAX package stands behind this one. The JAX
// SwendsenWang (spinglass_tpu/core/cluster.py:291) labels clusters with a
// lax.while_loop (min-label propagation over the active bonds with pointer
// jumping, until no label changes) and then flips every cluster not bonded
// to the ghost spin by its root's coin (cluster.py:294-300). The port runs
// the sweep inside a captured PT super-step, which cannot branch on the
// host, so the labels are found inside one launch.
//
// What it computes. Inputs: the bond masks [R, n, W] (bit q % 32 of word
// q / 32: slot q of the site's ELL row is bonded; C2, csrc/sw_bonds.cu, writes
// them), the start labels init [R, n] (-1: ghost-bonded, i: site i, n:
// padding) and idx [n, K]. The labels are the fixed point of the JAX loop,
// which is unique: each cluster of bonded sites takes its least start label,
// -1 if any site of it is ghost-bonded, else its least site index; a padding
// site (start label n, no bonds) takes min(n, label of site n - 1), as the
// JAX gather clamps the jump index to n - 1 (n where site n - 1 is padding).
// The bonds are symmetric (one uniform per undirected edge), so each is
// taken once, from its lower end. Then the flip: every active site whose label is >= 0 flips where its root's coin is 1: the
// caller's coins [R, n] (given mode) or the top bit of word r % 4 of
// Philox(root, r >> 2, 0, 2) (Philox mode, csrc/philox.cuh), as the plain
// version kernels/cluster_cuda.py:flip_reference does. Also n_clusters[r],
// the active sites that are their cluster's root, and rounds[r] = 1 (one
// pass over the bonds; the JAX loop's count is its rounds to the fixed
// point, at most n).
//
// Design (union-find instead of rounds to a fixed point):
//   nodes 0 .. n: node 0 is the ghost spin, node i + 1 site i; a parent
//   table P[n + 1] with P[x] <= x throughout. Phase 1: P[x] = x, or 0 for a
//   ghost-bonded site. Phase 2: each thread walks its sites' set bits
//   (__ffs; idx is loaded only for an active bond) and unites the two roots
//   by hooking the larger under the smaller with atomicCAS, so every root is
//   its tree's least node and the ghost, node 0, is the least of all (a warp
//   queues its lanes' unions in shared memory and runs them 32 at a time, so
//   the finds run on full warps whatever each site's bond count). Phase
//   3: one find per site (with pointer halving), the label root - 1, the
//   coin, the new spin, the count. One pass over the active bonds, where
//   the JAX loop takes rounds to its fixed point (18-21 on an SW sweep's
//   bonds on the TTT instance, each reading every site's K slots).
//   The table lives
//     SHARED  in one block's shared memory, one block per replica, where
//             (n + 1) * 4 bytes fit beside the union queues (the wrapper's
//             MAX_SHARED_NODES, kernels/cluster_cuda.py);
//     CLUSTER spread over a thread block cluster of 2-8 blocks per replica
//             (chunk = a power of two >= (n + 1) / blocks nodes each),
//             reached through distributed shared memory, with atomics on
//             the remote ranks and cluster.sync() between the phases; the
//             wrapper takes it where R is small (16 replicas x 8 blocks
//             fill 128 of the 132 SMs, against 16 with one block each) and
//             where the table fits no single block (up to 8 chunks of the
//             wrapper's MAX_CHUNK_NODES);
//     GLOBAL  in device memory (the caller's scratch [R, n + 1]), one block
//             per replica, beyond that.
//
// What bounds it on the H100: bytes. The masks, start labels and spins read
// once, the labels and new spins written once (coins [R, n] read in the
// given mode), idx [n, K] once (0.77 MB, loaded at the active bonds only;
// every replica's loads hit it in L2): ~26.7 MB at R=128 on the TTT
// instance (n = 10112, K = 19, W = 1), ~8 us at 3.35 TB/s. What holds
// it back is the finds and hooks: dependent shared-memory loads at random
// banks, a few per bond (benchmarks/sw_parts.py times the kernel with its
// unions, its phase-3 finds or its union queue left out). A table larger
// than the shared memory a block can have fails at launch: the runtime
// refuses the dynamic shared-memory size.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024, WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 8;
constexpr uint32_t TAG_COIN = 2u;
enum { SHARED = 0, CLUSTER = 1, GLOBAL = 2 };

struct LabelArgs {
  const int* idx;          // [n, K]
  const uint32_t* masks;   // [R, n, W]
  const int* init;         // [R, n]
  const float* spins;      // [R, n]
  const uint8_t* coins;    // [R, n] (given mode) or null (Philox)
  const unsigned long long* seed_ptr;
  uint32_t k0, k1;
  float* out;              // [R, n] new spins
  int* labels;             // [R, n]
  int* n_clusters;         // [R]
  int* rounds;             // [R]
  int* scratch;            // [R, n + 1] (GLOBAL)
  int n, k, w, shift;      // shift: log2 of a CLUSTER block's node chunk
};

// The parent table of one replica: SHARED the block's shared memory, GLOBAL
// the replica's scratch, CLUSTER the blocks' chunks of 2^shift nodes, the
// rank's address mapped (mapa) at each access.
template <int MODE>
struct Table {
  int* base;
  int shift;
  __device__ __forceinline__ volatile int* at(int x) const {
    if (MODE == CLUSTER)
      return cg::this_cluster().map_shared_rank(base, x >> shift) +
             (x & ((1 << shift) - 1));
    return base + x;
  }
};

template <int MODE>
__device__ __forceinline__ int find_root(const Table<MODE> t, int x) {
  int cur = *t.at(x);
  if (cur != x) {
    int prev = x, next;
    while (cur > (next = *t.at(cur))) {  // halve: point prev at its grandparent
      *t.at(prev) = next;
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

template <int MODE>
__device__ __forceinline__ void unite(const Table<MODE> t, int a, int b) {
  a = find_root(t, a);
  b = find_root(t, b);
  while (a != b) {
    if (a < b) {
      const int tmp = a;
      a = b;
      b = tmp;
    }
    // hook root a under the smaller root b, unless a was hooked meanwhile
    const int old = atomicCAS((int*)t.at(a), a, b);
    if (old == a) return;
    a = find_root(t, old);
    b = find_root(t, b);
  }
}

template <int MODE>
__device__ __forceinline__ void phase_sync() {
  if (MODE == CLUSTER)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) sw_labels_kernel(LabelArgs a) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[WARPS];
  __shared__ int2 queue[WARPS][2 * 32];   // each warp's pending unions
  const int n = a.n, nodes = n + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Table<MODE> t;
  t.shift = a.shift;
  int rank = 0, nblk = 1, r, lo = 0, hi = nodes;
  if (MODE == CLUSTER) {
    cg::cluster_group cl = cg::this_cluster();
    rank = (int)cl.block_rank();
    nblk = (int)cl.num_blocks();
    r = blockIdx.x / nblk;
    t.base = smem;
    lo = rank << a.shift;
    hi = min(lo + (1 << a.shift), nodes);
  } else {
    r = blockIdx.x;
    t.base = MODE == SHARED ? smem : a.scratch + (size_t)r * nodes;
  }
  const int* init = a.init + (size_t)r * n;
  // phase 1: every node its own root, ghost-bonded sites under the ghost
  for (int x = lo + threadIdx.x; x < hi; x += THREADS)
    *t.at(x) = (x == 0 || init[x - 1] == -1) ? 0 : x;
  phase_sync<MODE>();
  // phase 2: unite along the active bonds, each from its lower end. A warp
  // walks 32 sites' set bits together and queues their unions; every 32
  // queued unions run on all 32 lanes at once (the sites' bond counts vary,
  // so a lane per site would leave most lanes idle in the finds).
  const uint32_t* masks = a.masks + (size_t)r * n * a.w;
  int2* wq = queue[warp];
  const unsigned below = (1u << lane) - 1u;
  int queued = 0;  // warp-uniform
  for (int x0 = max(lo, 1) + warp * 32; x0 < hi; x0 += THREADS) {
    const int x = x0 + lane, i = x - 1;
    const bool in = x < hi;
    const bool live = in && init[i] != n;  // padding holds no bonds
    for (int wd = 0; wd < a.w; ++wd) {
      uint32_t m = in ? masks[(size_t)i * a.w + wd] : 0u;
      if (!live) m = 0u;
      while (__any_sync(0xffffffffu, m != 0u)) {
        int y[4];  // up to four bonds per lane, their idx loads together
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          y[u] = 0;
          if (m != 0u) {
            const int q = wd * 32 + __ffs(m) - 1;
            m &= m - 1u;
            const int j = __ldg(a.idx + (size_t)i * a.k + q);
            y[u] = j > i ? j + 1 : 0;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned want = __ballot_sync(0xffffffffu, y[u] != 0);
          if (y[u] != 0) wq[queued + __popc(want & below)] = make_int2(x, y[u]);
          queued += __popc(want);
          if (queued >= 32) {
            __syncwarp();
            const int2 e = wq[lane];
            unite(t, e.x, e.y);
            __syncwarp();
            if (lane < queued - 32) wq[lane] = wq[lane + 32];
            __syncwarp();
            queued -= 32;
          }
        }
      }
    }
  }
  __syncwarp();
  if (lane < queued) unite(t, wq[lane].x, wq[lane].y);
  phase_sync<MODE>();
  // phase 3: labels, the flip and the count of cluster roots
  uint32_t k0 = a.k0, k1 = a.k1;
  if (a.coins == nullptr) sgt::device_seed(a.seed_ptr, k0, k1);
  int pad_label = -2;  // found at the first padding site
  int roots = 0;
  for (int x = max(lo, 1) + threadIdx.x; x < hi; x += THREADS) {
    const int i = x - 1;
    const size_t e = (size_t)r * n + i;
    const bool act = init[i] != n;
    if (!act && pad_label == -2)
      pad_label = init[n - 1] == n ? n : find_root(t, n) - 1;
    const int lab = act ? find_root(t, x) - 1 : pad_label;
    a.labels[e] = lab;
    roots += act && lab == i;
    bool flip = false;
    if (act && lab >= 0) {
      if (a.coins != nullptr) {
        flip = a.coins[(size_t)r * n + lab] != 0;
      } else {
        uint32_t xw[4];
        sgt::philox4x32((uint32_t)lab, (uint32_t)(r >> 2), 0u, TAG_COIN, k0,
                        k1, xw);
        flip = (xw[r & 3] >> 31) != 0u;
      }
    }
    const float s = a.spins[e];
    a.out[e] = flip ? -s : s;
  }
  roots = __reduce_add_sync(0xffffffffu, roots);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = roots;
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = warp_sums[threadIdx.x];
    v = __reduce_add_sync(0xffffffffu, v);
    if (threadIdx.x == 0) warp_sums[0] = v;
  }
  __syncthreads();
  if (MODE == CLUSTER) {
    // every block's finds are done before rank 0 reads the blocks' counts,
    // and no block leaves before rank 0 has read its count
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (rank == 0 && threadIdx.x == 0) {
      int total = 0;
      for (int q = 0; q < nblk; ++q) total += *cl.map_shared_rank(warp_sums, q);
      a.n_clusters[r] = total;
      a.rounds[r] = 1;
    }
    cl.sync();
  } else if (threadIdx.x == 0) {
    a.n_clusters[r] = warp_sums[0];
    a.rounds[r] = 1;
  }
}

size_t g_allowed_smem[3] = {0, 0, 0};

template <int MODE>
cudaError_t launch(const LabelArgs& a, int R, int blocks, cudaStream_t s) {
  auto kernel = sw_labels_kernel<MODE>;
  const size_t smem = MODE == SHARED    ? (size_t)(a.n + 1) * sizeof(int)
                      : MODE == CLUSTER ? ((size_t)1 << a.shift) * sizeof(int)
                                        : 0;
  const cudaError_t err = sgt::allow_smem(kernel, smem, g_allowed_smem[MODE]);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = MODE == CLUSTER ? blocks : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = MODE == CLUSTER ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

}  // namespace

extern "C" {

// Labels [R, n], n_clusters [R], rounds [R] and the flipped spins out
// [R, n] from idx [n, K], the bond masks [R, n, W], the start labels init
// [R, n] and the spins [R, n], on `stream`. mode: 0 SHARED, 1 CLUSTER of
// `blocks` blocks per replica with chunks of 2^shift nodes, 2 GLOBAL on
// scratch [R, n + 1]. Coins: given where coins is not null, else Philox with
// the seed (by value, or at seed_ptr where that is not null). Returns the
// launch's error (0 on success).
int sgt_sw_labels(const int* idx, const uint32_t* masks, const int* init,
                  const float* spins, const uint8_t* coins,
                  unsigned long long seed, const unsigned long long* seed_ptr,
                  float* out, int* labels, int* n_clusters, int* rounds,
                  int* scratch, int n, int k, int R, int mode, int blocks,
                  int shift, void* stream) {
  if (n < 1 || k < 1 || R < 1 || spins == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  LabelArgs a;
  a.idx = idx;
  a.masks = masks;
  a.init = init;
  a.spins = spins;
  a.coins = coins;
  a.seed_ptr = seed_ptr;
  a.k0 = (uint32_t)(seed & 0xffffffffull);
  a.k1 = (uint32_t)(seed >> 32);
  a.out = out;
  a.labels = labels;
  a.n_clusters = n_clusters;
  a.rounds = rounds;
  a.scratch = scratch;
  a.n = n;
  a.k = k;
  a.w = (k + 31) / 32;
  a.shift = shift;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == SHARED) {
    err = launch<SHARED>(a, R, 1, s);
  } else if (mode == CLUSTER) {
    if (blocks < 2 || blocks > MAX_CLUSTER || shift < 0 || shift > 30 ||
        ((long long)blocks << shift) < (long long)n + 1)
      return (int)cudaErrorInvalidValue;
    err = launch<CLUSTER>(a, R, blocks, s);
  } else if (mode == GLOBAL) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    err = launch<GLOBAL>(a, R, 1, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
