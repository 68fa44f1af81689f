// C2 on Hopper: the bond and ghost activation of one Swendsen-Wang sweep.
//
// No Pallas kernel of the JAX package stands behind this one: it replaces
// the array code at the head of SwendsenWang._sweep
// (spinglass_tpu/core/cluster.py:240-275), array code over [R, Np, K] float
// temporaries (its plain version, kernels/cluster_cuda.py:bonds_reference,
// is the same in PyTorch). Per replica r and site i:
//
//   for each ELL slot q (neighbour j = idx[i, q], coupling v = val[i, q]):
//       jss  = v * s[r, i] * s[r, j]
//       bond = jss > 0 and u_edge < -expm1f(-2 beta[r] jss)
//     with one uniform per undirected edge: at the lower end (i < j) the
//     slot's own draw, at the upper end the draw of the lower end's slot
//     (rev_i[i, q], rev_k[i, q]);
//   masks[r, i, w]: the bonds of slots 32w .. 32w + 31 as bits (w < W =
//     ceil(K / 32); a dense problem in ELL form has K = N - 1, so W > 1);
//   init[r, i]: -1 where the site is active and its ghost bond is on
//     (h_i s_i > 0 and u_ghost < -expm1f(-2 beta h_i s_i)), i on the other
//     active sites, n on padding: C1's start labels.
//
// Two draw modes, as K2-K4 have:
//   given:  the caller's u_dir [R, n, K] and u_ghost [R, n]
//           (SwendsenWang.sweep_with_draws, the JAX comparison);
//   Philox: the seed by value or in device memory (seed_ptr; a captured
//           super-step refills its slot per replay, so no [R, n, K] draw is
//           made outside the graph). Counter layout (csrc/philox.cuh, the
//           Swendsen-Wang stream; its PyTorch twin is
//           kernels/metropolis_cuda.py:sw_philox_draws):
//             bond uniform of the edge at (lower site a, its slot b),
//               replica 4g + c: word c of Philox(a, g, b, 0);
//             ghost uniform of site i: word c of Philox(i, g, 0, 1);
//             (the cluster coin, tag 2, is C1's: csrc/sw_labels.cu).
//           The upper end of an edge computes the same counter through
//           rev_i / rev_k, so both ends see one uniform, and the Philox mode
//           equals the given mode fed u_dir[r, a, b] = that word.
//
// Built without --use_fast_math: expm1f is the CUDA math library's, as
// torch.expm1 on the card, so every decision equals the plain version's bit
// for bit (the products are exact on +-1 spins; -2 beta is exact).
//
// Design: a block takes one group of four replicas (blockIdx.y) and a run
// of sites (blockIdx.x, `spt` sites per thread), and first packs the
// group's spin signs of all n sites into shared memory, one byte per site
// (bit c: replica 4g + c is -1): a neighbour's four spins are then one
// shared byte, where a gather from the [R, n] spins would fetch a 32-byte
// sector per replica for 4 useful bytes. Spins are +-1, so a slot's four
// satisfied flags are sign bits xor-ed (v s_i s_j > 0), and jss = |v|
// exactly where a bond is satisfied.
// Beyond STAGE_MAX sites the block gathers from device memory instead. A
// thread keeps its site's four spins and -2 beta in registers, walks the K
// slots once (the padding slots, v = 0, cost a load), and draws a uniform
// only where one of its four replicas has a satisfied bond (jss > 0). The
// slots' loads are issued CHUNK at a time (one wait per chunk). The masks go
// out as one 32-bit store per word and replica. The host picks
// `spt` so that the grid is about two blocks per SM (fewer copies of the
// staged signs).
//
// What bounds it on the H100: bytes, the spins [R, n] float32 read once,
// idx / val / rev_i / rev_k [n, K] int32 / float32 read once (per group
// through L2), the masks [R, n, W] and init [R, n] written once: ~16 MB at
// R=128 on the TTT instance (n = 10112, K = 19), ~5 us at 3.35 TB/s. The
// Philox mode adds 10 rounds per (site, slot, group of 4 replicas) with a
// satisfied bond, at both ends of an edge (~100 integer operations each,
// up to 2 x 6.1 M runs at R=128: ~6-10 us counted at the float32 rate); the
// given mode reads u_dir at the lower ends instead (up to 49 MB at R=128).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 512, CHUNK = 4;
constexpr int STAGE_MAX = 200 * 1024;  // sites whose sign bytes a block stages
constexpr uint32_t TAG_BOND = 0u, TAG_GHOST = 1u;

template <bool PHILOX, bool STAGED>
__global__ void __launch_bounds__(THREADS, 2)
sw_bonds_kernel(const int* __restrict__ idx,       // [n, K] neighbour sites
                const float* __restrict__ val,     // [n, K] couplings (0: pad)
                const float* __restrict__ h,       // [n] fields
                const uint8_t* __restrict__ active,  // [n] 0 / 1
                const int* __restrict__ rev_i,     // [n, K] lower end's site
                const int* __restrict__ rev_k,     // [n, K] lower end's slot
                const float* __restrict__ spins,   // [R, n] +-1
                const float* __restrict__ beta,    // [R]
                const float* __restrict__ u_dir,   // [R, n, K] (given mode)
                const float* __restrict__ u_ghost,  // [R, n] (given mode)
                uint32_t k0, uint32_t k1,
                const unsigned long long* __restrict__ seed_ptr,
                uint32_t* __restrict__ masks,      // [R, n, W] out
                int* __restrict__ init,            // [R, n] out
                int n, int k, int w, int R, int spt) {
  extern __shared__ uint8_t signs[];  // STAGED: [n] sign bits of the group
  const int g = blockIdx.y;
  if (PHILOX) sgt::device_seed(seed_ptr, k0, k1);
  const int r0 = 4 * g;
  const int nr = R - r0 < 4 ? R - r0 : 4;
  if (STAGED) {  // four sites per thread and pass: 16 loads in flight
    for (int j = threadIdx.x; j < n; j += 4 * THREADS) {
      float sv[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sv[e][c] = (j + e * THREADS < n && c < nr)
                         ? spins[(size_t)(r0 + c) * n + j + e * THREADS]
                         : 1.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t bits = 0u;
#pragma unroll
        for (int c = 0; c < 4; ++c) bits |= (sv[e][c] < 0.f ? 1u : 0u) << c;
        if (j + e * THREADS < n) signs[j + e * THREADS] = (uint8_t)bits;
      }
    }
    __syncthreads();
  }
  const uint32_t live = (1u << nr) - 1u;  // the group's replicas
  const int i_end = min(n, (blockIdx.x + 1) * THREADS * spt);
  for (int i = blockIdx.x * THREADS * spt + threadIdx.x; i < i_end;
       i += THREADS) {
    float si[4], b2[4];
    uint32_t si_neg = 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      si[c] = c < nr ? spins[(size_t)(r0 + c) * n + i] : 0.f;
      b2[c] = c < nr ? -2.f * beta[r0 + c] : 0.f;
      si_neg |= (si[c] < 0.f ? 1u : 0u) << c;
    }
    // ghost bonds and the start labels
    {
      const bool act = active[i] != 0;
      float ug[4];
      if (PHILOX) {
        uint32_t x[4];
        sgt::philox4x32((uint32_t)i, (uint32_t)g, 0u, TAG_GHOST, k0, k1, x);
#pragma unroll
        for (int c = 0; c < 4; ++c) ug[c] = sgt::word_uniform(x[c]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ug[c] = c < nr ? u_ghost[(size_t)(r0 + c) * n + i] : 1.f;
      }
      const float hi = h[i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= nr) break;
        const float hs = hi * si[c];
        const bool ghost = act && hs > 0.f && ug[c] < -expm1f(b2[c] * hs);
        init[(size_t)(r0 + c) * n + i] = !act ? n : (ghost ? -1 : i);
      }
    }
    const size_t row = (size_t)i * k;
    for (int wd = 0; wd < w; ++wd) {
      uint32_t bits[4] = {0u, 0u, 0u, 0u};
      const int q_end = (wd + 1) * 32 < k ? (wd + 1) * 32 : k;
      for (int q0 = wd * 32; q0 < q_end; q0 += CHUNK) {
        // the chunk's slots loaded together: one wait per chunk, not per slot
        float v[CHUNK];
        int jn[CHUNK], ea[CHUNK], eb[CHUNK];
#pragma unroll
        for (int e = 0; e < CHUNK; ++e) {
          const bool in = q0 + e < q_end;
          v[e] = in ? __ldg(val + row + q0 + e) : 0.f;
          jn[e] = in ? __ldg(idx + row + q0 + e) : 0;
        }
#pragma unroll
        for (int e = 0; e < CHUNK; ++e) {  // the edge's lower end and slot
          ea[e] = i;
          eb[e] = q0 + e;
          if (v[e] != 0.f && !(i < jn[e])) {
            ea[e] = __ldg(rev_i + row + q0 + e);
            eb[e] = __ldg(rev_k + row + q0 + e);
          }
        }
#pragma unroll
        for (int e = 0; e < CHUNK; ++e) {
          if (v[e] == 0.f) continue;
          uint32_t sj_neg = 0u;
          if (STAGED) {
            sj_neg = signs[jn[e]];
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (c < nr && spins[(size_t)(r0 + c) * n + jn[e]] < 0.f)
                sj_neg |= 1u << c;
          }
          // v s_i s_j > 0 where the three signs multiply to +; then, on +-1
          // spins, jss = |v| exactly
          const uint32_t sat =
              ~((v[e] < 0.f ? 0xfu : 0u) ^ si_neg ^ sj_neg) & live;
          if (sat == 0u) continue;
          const float jss = fabsf(v[e]);
          float u[4];
          if (PHILOX) {
            uint32_t x[4];
            sgt::philox4x32((uint32_t)ea[e], (uint32_t)g, (uint32_t)eb[e],
                            TAG_BOND, k0, k1, x);
#pragma unroll
            for (int c = 0; c < 4; ++c) u[c] = sgt::word_uniform(x[c]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              u[c] = c < nr ? u_dir[((size_t)(r0 + c) * n + ea[e]) * k + eb[e]]
                            : 1.f;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (((sat >> c) & 1u) && u[c] < -expm1f(b2[c] * jss))
              bits[c] |= 1u << ((q0 + e) & 31);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < nr) masks[((size_t)(r0 + c) * n + i) * w + wd] = bits[c];
    }
  }
}

size_t g_allowed_smem[4] = {0, 0, 0, 0};

template <bool PHILOX, bool STAGED>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t s, const int* idx,
                   const float* val, const float* h, const uint8_t* active,
                   const int* rev_i, const int* rev_k, const float* spins,
                   const float* beta, const float* u_dir,
                   const float* u_ghost, uint32_t k0, uint32_t k1,
                   const unsigned long long* seed_ptr, uint32_t* masks,
                   int* init, int n, int k, int w, int R, int spt) {
  auto kernel = sw_bonds_kernel<PHILOX, STAGED>;
  const cudaError_t err =
      sgt::allow_smem(kernel, smem, g_allowed_smem[2 * PHILOX + STAGED]);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, s>>>(idx, val, h, active, rev_i, rev_k, spins,
                                     beta, u_dir, u_ghost, k0, k1, seed_ptr,
                                     masks, init, n, k, w, R, spt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Masks [R, n, W] and start labels [R, n] of one SW sweep (see the note
// above) on `stream`. Given mode where u_dir is not null (u_ghost then too),
// else Philox with the seed (k0, k1) or, where seed_ptr is not null, the one
// it points to. Returns cudaGetLastError() after the launch (0 on success).
int sgt_sw_bonds(const int* idx, const float* val, const float* h,
                 const uint8_t* active, const int* rev_i, const int* rev_k,
                 const float* spins, const float* beta, const float* u_dir,
                 const float* u_ghost, unsigned long long seed,
                 const unsigned long long* seed_ptr, uint32_t* masks,
                 int* init, int n, int k, int R, void* stream) {
  if (n < 1 || k < 1 || R < 1) return (int)cudaErrorInvalidValue;
  if ((u_dir == nullptr) != (u_ghost == nullptr))
    return (int)cudaErrorInvalidValue;
  const int w = (k + 31) / 32;
  const int groups = (R + 3) / 4;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  // sites per thread: the fewest that keep the grid within ~2 blocks per SM
  const int runs = (n + THREADS - 1) / THREADS;
  const int per_group = max(1, 264 / groups);
  const int spt = min(16, (runs + per_group - 1) / per_group);
  const dim3 grid((n + THREADS * spt - 1) / (THREADS * spt), groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t k0 = (uint32_t)(seed & 0xffffffffull);
  const uint32_t k1 = (uint32_t)(seed >> 32);
  const bool staged = n <= STAGE_MAX;
  const size_t smem = staged ? (size_t)n : 0;
  cudaError_t err;
  if (u_dir != nullptr)
    err = staged ? launch<false, true>(grid, smem, s, idx, val, h, active,
                                       rev_i, rev_k, spins, beta, u_dir,
                                       u_ghost, k0, k1, nullptr, masks, init,
                                       n, k, w, R, spt)
                 : launch<false, false>(grid, smem, s, idx, val, h, active,
                                        rev_i, rev_k, spins, beta, u_dir,
                                        u_ghost, k0, k1, nullptr, masks, init,
                                        n, k, w, R, spt);
  else
    err = staged ? launch<true, true>(grid, smem, s, idx, val, h, active,
                                      rev_i, rev_k, spins, beta, nullptr,
                                      nullptr, k0, k1, seed_ptr, masks, init,
                                      n, k, w, R, spt)
                 : launch<true, false>(grid, smem, s, idx, val, h, active,
                                       rev_i, rev_k, spins, beta, nullptr,
                                       nullptr, k0, k1, seed_ptr, masks, init,
                                       n, k, w, R, spt);
  return (int)err;
}

const char* sgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
