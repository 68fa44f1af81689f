"""The port's host C++ routines: ``kernels.cpp`` built at first use with
the host's C++ compiler and bound with ctypes, with numpy fallbacks.

The counterpart of ``spinglass_tpu.native``: the same six C functions from a
copy of its source, built with its flags (``-O3 -march=native -shared
-fPIC``), and the same wrappers (``build_ell``, ``greedy_coloring_csr``
plain and ``balanced``, ``cardinality_terms_batch``,
``scatter_add_symmetric``) with its signatures and return types, so that
both packages give the same arrays bit for bit. These are host steps of the
problem path (``core.problem.IsingProblem.from_terms``,
``kernels.sparse.build_ell`` under ``EllProblem.from_coo``, the colourings
of ``core.topology`` under ``make_engine``); the card's kernels are in
``csrc/``.

Build. The library goes into the package's git-ignored ``build/``
directory as ``native-<hash>.so``, the hash over the source, the
compiler command and what ``-march=native`` stands for on this host (the
compiler's own expansion), so an edited source or flag, or a checkout
carried to a host with another CPU, builds anew. Each build
writes a file of its own and renames it into place (``os.replace``), so
processes that build at once never load a half-written library. Nothing is
built at import.

Fallback. Where no compiler (``g++``, ``c++``, ``clang++``) builds the
source, every wrapper runs its numpy version, which gives the same output.
That is never silent: ``BACKEND`` says which path serves the calls
("native" or "numpy"; None before the first call) and ``CALLS`` counts each
wrapper's calls per path, so a caller that needs the C++ path (chip_smoke's
native phase) can check that it served every call.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "kernels.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(SOURCE)), "build")
COMPILERS = ("g++", "c++", "clang++")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

BACKEND: Optional[str] = None  # "native" or "numpy", once decided
CALLS: collections.Counter = collections.Counter()  # (wrapper, path) -> n

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def native_target(cxx: str) -> str:
    """The target flags ``cxx -march=native`` expands to on this host
    (gcc's ``-m...`` options, clang's ``-target-cpu`` and
    ``-target-feature`` values); raises OSError or CalledProcessError where
    ``cxx`` does not run."""
    out = subprocess.run([cxx, "-march=native", "-E", "-v", "-x", "c++",
                          os.devnull, "-o", os.devnull], check=True,
                         capture_output=True, text=True, timeout=60).stderr
    flags = []
    for line in out.splitlines():
        if "cc1" not in line:
            continue
        toks = line.split()
        flags += [tok for i, tok in enumerate(toks) if tok.startswith("-m")
                  or toks[i - 1] in ("-target-cpu", "-target-feature")]
    return " ".join(flags)


def library_path(cxx: str) -> str:
    """``BUILD_DIR/native-<hash>.so``, the hash over the source, the
    command that builds it with ``cxx`` and ``native_target(cxx)``."""
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join((cxx,) + CXX_FLAGS).encode())
    digest.update(native_target(cxx).encode())
    return os.path.join(BUILD_DIR, f"native-{digest.hexdigest()[:16]}.so")


def _compile() -> Optional[str]:
    """The built library's path (built now unless it exists), trying each
    compiler in turn; None where none builds it."""
    for cxx in COMPILERS:
        tmp = None
        try:
            out = library_path(cxx)
            if os.path.exists(out):
                return out
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp], check=True,
                           capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, OSError,
                subprocess.TimeoutExpired):
            if tmp and os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)
        return out
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The bound library, built at the first call; None where no compiler
    builds it (``BACKEND`` is then "numpy")."""
    global _lib, BACKEND
    with _lock:
        if BACKEND is not None:
            return _lib
        so = _compile()
        if so is None:
            BACKEND = "numpy"
            return None
        lib = ctypes.CDLL(so)
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        c = ctypes.c_int64
        lib.build_ell.argtypes = [i64p, i64p, f64p, c, c, c, i32p, f32p]
        lib.build_ell.restype = c
        lib.greedy_coloring.argtypes = [i64p, i64p, c, c, i64p]
        lib.greedy_coloring.restype = c
        lib.greedy_coloring_balanced.argtypes = [i64p, i64p, c, c, i64p]
        lib.greedy_coloring_balanced.restype = c
        lib.cardinality_terms.argtypes = [i64p, i64p, f64p, f64p, c,
                                          i64p, i64p, f64p, i64p, f64p]
        lib.cardinality_terms.restype = c
        lib.at_most_one_pairs.argtypes = [i64p, i64p, c, i64p, i64p]
        lib.at_most_one_pairs.restype = c
        lib.scatter_add_symmetric.argtypes = [i64p, i64p, f64p, c, c, f64p]
        lib.scatter_add_symmetric.restype = None
        _lib, BACKEND = lib, "native"
        return _lib


def available() -> bool:
    """Whether the C++ library serves the wrappers."""
    return get_lib() is not None


def _served(name: str, lib) -> None:
    with _lock:
        CALLS[(name, "numpy" if lib is None else "native")] += 1


# ---------------------------------------------------------------------------
# The wrappers, each with its numpy version
# ---------------------------------------------------------------------------

def build_ell(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              n_pad: int, k: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Symmetric COO (both directions) -> (idx [Np, K] int32, val [Np, K]
    float32, max_degree). Each row keeps its entries in COO order (entries
    beyond k are dropped; max_degree counts them); empty slots point at the
    row itself with value 0; rows outside [0, n_pad) are skipped."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    idx = np.ascontiguousarray(
        np.tile(np.arange(n_pad, dtype=np.int32)[:, None], (1, k)))
    val = np.zeros((n_pad, k), np.float32)
    lib = get_lib()
    _served("build_ell", lib)
    if lib is not None:
        max_deg = int(lib.build_ell(rows, cols, vals, len(rows), n_pad, k,
                                    idx, val))
        return idx, val, max_deg
    ok = (rows >= 0) & (rows < n_pad)
    rows, cols, vals = rows[ok], cols[ok], vals[ok]
    order = np.argsort(rows, kind="stable")
    r_s = rows[order]
    counts = np.bincount(r_s, minlength=n_pad)
    pos = np.arange(len(r_s)) - (np.cumsum(counts) - counts)[r_s]
    keep = pos < k
    idx[r_s[keep], pos[keep]] = cols[order][keep].astype(np.int32)
    val[r_s[keep], pos[keep]] = vals[order][keep].astype(np.float32)
    return idx, val, int(counts.max(initial=0))


def greedy_coloring_csr(indptr: np.ndarray, indices: np.ndarray, n: int,
                        max_colors: int = 256,
                        balanced: bool = False) -> np.ndarray:
    """Greedy colouring of a CSR adjacency, highest degree first (stable):
    colour[i] in [0, n_colours) int64. Plain: the least colour no
    neighbour has. ``balanced``: among the feasible colours already
    opened the one with the smallest class (ties: the lowest), a new one
    only when every opened one is blocked. Raises ``ValueError`` beyond
    ``max_colors``, and for an adjacency that is not n vertices' CSR (the
    C++ loop reads ``colors[indices[p]]`` unchecked)."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    if (indptr.shape != (n + 1,) or indptr[0] != 0
            or np.any(np.diff(indptr) < 0) or indptr[-1] != len(indices)
            or (len(indices) and not 0 <= indices.min() <= indices.max() < n)):
        raise ValueError(f"not the CSR adjacency of {n} vertices")
    colors = np.zeros(n, np.int64)
    lib = get_lib()
    _served("greedy_coloring_balanced" if balanced else "greedy_coloring",
            lib)
    if lib is not None:
        fn = (lib.greedy_coloring_balanced if balanced
              else lib.greedy_coloring)
        if int(fn(indptr, indices, n, max_colors, colors)) < 0:
            raise ValueError(f"graph needs >{max_colors} colors")
        return colors
    colors[:] = -1
    class_size = np.zeros(max_colors, np.int64)
    for v in np.argsort(-np.diff(indptr), kind="stable"):
        nb = indices[indptr[v]:indptr[v + 1]]
        used = set(colors[nb][colors[nb] >= 0].tolist())
        if balanced:
            opened = int(np.count_nonzero(class_size))
            feasible = [c for c in range(opened) if c not in used]
            if feasible:
                c = min(feasible, key=lambda c: (class_size[c], c))
            elif opened < max_colors:
                c = opened
            else:
                raise ValueError(f"graph needs >{max_colors} colors")
        else:
            c = 0
            while c in used:
                c += 1
            if c >= max_colors:
                raise ValueError(f"graph needs >{max_colors} colors")
        colors[v] = c
        class_size[c] += 1
    return colors


def cardinality_terms_batch(supports: list, ks: np.ndarray,
                            weights: np.ndarray):
    """Expand many exactly-k cardinality constraints at once: constraint c
    over the spin indices ``supports[c]`` with target ``ks[c]`` and weight
    ``weights[c]`` (spin space). Returns (qi, qj, qv, li, lv, const) in the
    ``core.constraints.Terms`` convention: -2 w per unordered pair, 2 w t
    per index (t = 2 k - |support|), const = sum w (|support| + t^2)."""
    offsets = np.zeros(len(supports) + 1, np.int64)
    for i, s in enumerate(supports):
        offsets[i + 1] = offsets[i] + len(s)
    indices = (np.concatenate([np.asarray(s, np.int64) for s in supports])
               if supports else np.zeros(0, np.int64))
    sizes = np.diff(offsets)
    targets = 2.0 * np.asarray(ks, np.float64) - sizes
    w = np.asarray(weights, np.float64)
    n_pairs = int((sizes * (sizes - 1) // 2).sum())
    n_lin = int(sizes.sum())
    qi = np.zeros(n_pairs, np.int64)
    qj = np.zeros(n_pairs, np.int64)
    qv = np.zeros(n_pairs, np.float64)
    li = np.zeros(n_lin, np.int64)
    lv = np.zeros(n_lin, np.float64)
    lib = get_lib()
    _served("cardinality_terms", lib)
    if lib is not None and len(supports):
        lib.cardinality_terms(np.ascontiguousarray(indices), offsets,
                              np.ascontiguousarray(targets),
                              np.ascontiguousarray(w), len(supports),
                              qi, qj, qv, li, lv)
    else:
        qn = ln = 0
        for c, s in enumerate(supports):
            s = np.asarray(s, np.int64)
            m = len(s)
            li[ln:ln + m] = s
            lv[ln:ln + m] = 2.0 * w[c] * targets[c]
            ln += m
            iu, ju = np.triu_indices(m, k=1)
            qi[qn:qn + len(iu)] = s[iu]
            qj[qn:qn + len(iu)] = s[ju]
            qv[qn:qn + len(iu)] = -2.0 * w[c]
            qn += len(iu)
    const = float(np.sum(w * (sizes + targets ** 2)))
    return qi, qj, qv, li, lv, const


def scatter_add_symmetric(qi, qj, qv, n: int) -> np.ndarray:
    """Dense symmetric J [n, n] float64: J[i, j] += v and J[j, i] += v for
    each term in order (terms with an index outside [0, n) skipped), then a
    zero diagonal. The numpy version adds in the same order (``np.add.at``
    is unbuffered and takes its indices in order), so both paths give the
    same sums bit for bit."""
    qi = np.ascontiguousarray(qi, np.int64)
    qj = np.ascontiguousarray(qj, np.int64)
    qv = np.ascontiguousarray(qv, np.float64)
    j = np.zeros((n, n), np.float64)
    lib = get_lib()
    _served("scatter_add_symmetric", lib)
    if lib is not None:
        lib.scatter_add_symmetric(qi, qj, qv, len(qi), n, j)
        return j
    ok = (qi >= 0) & (qj >= 0) & (qi < n) & (qj < n)
    a, b, v = qi[ok], qj[ok], qv[ok]
    np.add.at(j, (np.stack([a, b], 1).ravel(), np.stack([b, a], 1).ravel()),
              np.repeat(v, 2))
    np.fill_diagonal(j, 0.0)
    return j
