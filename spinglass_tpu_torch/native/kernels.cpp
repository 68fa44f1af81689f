// Native host-side routines of spinglass_tpu_torch (the PyTorch/CUDA port).
//
// A copy of spinglass_tpu/native/kernels.cpp, unchanged in behaviour: the
// same functions give the same outputs bit for bit, so that layouts and
// colourings do not depend on which package built them. The GPU kernels
// are in csrc/; these C++ routines cover the *host* hot paths that would
// otherwise run as Python loops: problem encoding (constraint term
// generation, the dense scatter of IsingProblem.from_terms), ELL sparse-
// format construction (kernels/sparse.build_ell), and greedy graph
// colouring (core/topology: engine selection for 100k-spin sparse
// instances).
//
// Exposed with a plain C ABI for ctypes (native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// COO (symmetric, both directions present) -> ELL padded neighbor lists.
// idx must be pre-filled by the caller with self-indices; val zeroed.
// rows/cols sorted by row not required. Returns max degree encountered
// (may exceed k; entries beyond k are dropped).
int64_t build_ell(const int64_t* rows, const int64_t* cols,
                  const double* vals, int64_t nnz, int64_t n_pad, int64_t k,
                  int32_t* idx, float* val) {
  std::vector<int64_t> fill(n_pad, 0);
  int64_t max_deg = 0;
  for (int64_t e = 0; e < nnz; ++e) {
    int64_t r = rows[e];
    if (r < 0 || r >= n_pad) continue;
    int64_t f = fill[r]++;
    if (fill[r] > max_deg) max_deg = fill[r];
    if (f < k) {
      idx[r * k + f] = static_cast<int32_t>(cols[e]);
      val[r * k + f] = static_cast<float>(vals[e]);
    }
  }
  return max_deg;
}

// Greedy vertex coloring on CSR adjacency, high-degree-first order.
// Returns number of colors used, or -1 if max_colors exceeded.
int64_t greedy_coloring(const int64_t* indptr, const int64_t* indices,
                        int64_t n, int64_t max_colors, int64_t* colors) {
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return (indptr[a + 1] - indptr[a]) > (indptr[b + 1] - indptr[b]);
  });
  std::fill(colors, colors + n, -1);
  std::vector<uint8_t> used(static_cast<size_t>(max_colors), 0);
  int64_t n_colors = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    int64_t v = order[oi];
    std::fill(used.begin(), used.end(), 0);
    for (int64_t p = indptr[v]; p < indptr[v + 1]; ++p) {
      int64_t c = colors[indices[p]];
      if (c >= 0 && c < max_colors) used[static_cast<size_t>(c)] = 1;
    }
    int64_t c = 0;
    while (c < max_colors && used[static_cast<size_t>(c)]) ++c;
    if (c >= max_colors) return -1;
    colors[v] = c;
    if (c + 1 > n_colors) n_colors = c + 1;
  }
  return n_colors;
}

// Balanced (equitable-ish) greedy coloring: among feasible ALREADY-OPENED
// colors pick the smallest class (ties -> lowest index); open a new color
// only when every opened one is blocked. Semantics match the Python
// fallback in native/__init__.py (greedy_coloring_csr, balanced=True) exactly
// (same descending-degree stable order, same tie-breaks), so native and
// fallback paths produce IDENTICAL colorings — layouts and checkpoints
// must not depend on which path compiled. Returns n_colors, -1 on
// overflow. used_mark is timestamped with the visit index to avoid a
// per-vertex O(max_colors) refill.
int64_t greedy_coloring_balanced(const int64_t* indptr,
                                 const int64_t* indices, int64_t n,
                                 int64_t max_colors, int64_t* colors) {
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return (indptr[a + 1] - indptr[a]) > (indptr[b + 1] - indptr[b]);
  });
  std::fill(colors, colors + n, -1);
  std::vector<int64_t> class_size(static_cast<size_t>(max_colors), 0);
  std::vector<int64_t> used_mark(static_cast<size_t>(max_colors), -1);
  int64_t opened = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    int64_t v = order[oi];
    for (int64_t p = indptr[v]; p < indptr[v + 1]; ++p) {
      int64_t c = colors[indices[p]];
      if (c >= 0) used_mark[static_cast<size_t>(c)] = oi;
    }
    int64_t best = -1;
    for (int64_t c = 0; c < opened; ++c) {
      if (used_mark[static_cast<size_t>(c)] != oi &&
          (best < 0 || class_size[static_cast<size_t>(c)] <
                           class_size[static_cast<size_t>(best)]))
        best = c;
    }
    if (best < 0) {
      if (opened >= max_colors) return -1;
      best = opened++;
    }
    colors[v] = best;
    class_size[static_cast<size_t>(best)]++;
  }
  return opened;
}

// Batch cardinality-constraint expansion: for constraint c over support
// indices[offsets[c]:offsets[c+1]] with target t_c and weight w_c, emit the
// quadratic pair terms of w * (sum s - t)^2 (value -2*w per unordered pair,
// matching core.constraints.quadratic_penalty_terms with unit
// coefficients) and linear terms (value 2*w*t per index). Outputs must be
// sized: pairs n_pairs_total(offsets), linear = offsets[n_constraints].
// Returns the number of pair terms written.
int64_t cardinality_terms(const int64_t* indices, const int64_t* offsets,
                          const double* targets, const double* weights,
                          int64_t n_constraints,
                          int64_t* qi, int64_t* qj, double* qv,
                          int64_t* li, double* lv) {
  int64_t qn = 0, ln = 0;
  for (int64_t c = 0; c < n_constraints; ++c) {
    int64_t lo = offsets[c], hi = offsets[c + 1];
    double w = weights[c], t = targets[c];
    for (int64_t a = lo; a < hi; ++a) {
      li[ln] = indices[a];
      lv[ln++] = 2.0 * w * t;
      for (int64_t b = a + 1; b < hi; ++b) {
        qi[qn] = indices[a];
        qj[qn] = indices[b];
        qv[qn++] = -2.0 * w;
      }
    }
  }
  return qn;
}

// Pairwise "at most one" penalty expansion (the slot-uniqueness constraints
// of scheduling/coordination/VRP): for each group, emit binary-quadratic
// pair terms with coefficient coeff (binary-var convention; the Python side
// converts x-space to spin-space). Returns pairs written.
int64_t at_most_one_pairs(const int64_t* indices, const int64_t* offsets,
                          int64_t n_groups, int64_t* qi, int64_t* qj) {
  int64_t qn = 0;
  for (int64_t g = 0; g < n_groups; ++g) {
    for (int64_t a = offsets[g]; a < offsets[g + 1]; ++a)
      for (int64_t b = a + 1; b < offsets[g + 1]; ++b) {
        qi[qn] = indices[a];
        qj[qn++] = indices[b];
      }
  }
  return qn;
}

// Dense symmetric scatter-add of quadratic terms: J[i,j] += v; J[j,i] += v.
// Replaces np.add.at (notoriously slow) for multi-million-term encodes.
void scatter_add_symmetric(const int64_t* qi, const int64_t* qj,
                           const double* qv, int64_t n_terms, int64_t n,
                           double* j_out) {
  for (int64_t t = 0; t < n_terms; ++t) {
    int64_t a = qi[t], b = qj[t];
    if (a < 0 || b < 0 || a >= n || b >= n) continue;
    j_out[a * n + b] += qv[t];
    j_out[b * n + a] += qv[t];
  }
  for (int64_t d = 0; d < n; ++d) j_out[d * n + d] = 0.0;
}

}  // extern "C"
