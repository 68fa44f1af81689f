"""Host seconds of the port's C++ routines (``spinglass_tpu_torch.native``)
against their numpy versions, on the sparse problem path's host steps.

    python -m spinglass_tpu_torch.benchmarks.native_host [N ...]

On ``sparse_random_graph_coo(n, avg_degree=6, gaussian, seed 42)`` at each
N (default 100,000 and 1,000,000 spins) times, by the host clock, the
greedy colouring of the graph's CSR adjacency, plain (first fit, as
``make_engine`` colours a dense J's non-zeros) and balanced (the sorted
sparse engines' colouring), and ``build_ell`` (COO -> ELL, as
``EllProblem.from_coo`` builds), each once through the C++ library and
once through the numpy version, and checks that the two give the same
arrays bit for bit. Stops unless the C++ library built. Prints one line per
step and, last, one JSON object of the seconds. The host's CPU is what
these times measure: run it on the machine whose numbers you want.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np

from spinglass_tpu_torch import native


@contextlib.contextmanager
def numpy_path():
    """Within: every native wrapper runs its numpy version, as on a host
    with no C++ compiler."""
    real = native.get_lib
    native.get_lib = lambda: None
    try:
        yield
    finally:
        native.get_lib = real


def compare(n: int, seed: int = 42) -> dict:
    """{step: {"native_s", "numpy_s", "same"}} at n spins (see the module's
    docstring); raises unless the C++ library serves the native calls."""
    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import round_up

    if not native.available():
        raise RuntimeError("the native library did not build (no C++ "
                           "compiler?)")
    rows, cols, vals = topology.sparse_random_graph_coo(
        n, avg_degree=6.0, dist="gaussian", seed=seed)
    order = np.argsort(rows, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, rows[order] + 1, 1)
    indptr = np.cumsum(indptr)
    indices = cols[order].astype(np.int64)
    n_pad = round_up(n)
    k = int(np.diff(indptr).max())
    steps = {
        "coloring": lambda: native.greedy_coloring_csr(indptr, indices, n),
        "coloring_balanced": lambda: native.greedy_coloring_csr(
            indptr, indices, n, balanced=True),
        "build_ell": lambda: native.build_ell(rows, cols, vals, n_pad, k),
    }
    out = {}
    for name, step in steps.items():
        served = dict(native.CALLS)
        t0 = time.perf_counter()
        fast = step()
        t1 = time.perf_counter()
        with numpy_path():
            slow = step()
        t2 = time.perf_counter()
        paths = {path for key, v in native.CALLS.items()
                 if v != served.get(key, 0) for path in key[1:]}
        if paths != {"native", "numpy"}:
            raise RuntimeError(f"{name}: served by {paths}")
        fast = fast if isinstance(fast, tuple) else (fast,)
        slow = slow if isinstance(slow, tuple) else (slow,)
        same = all(np.array_equal(a, b) and np.asarray(a).dtype ==
                   np.asarray(b).dtype for a, b in zip(fast, slow))
        out[name] = {"native_s": t1 - t0, "numpy_s": t2 - t1, "same": same}
    return out


def main(argv=None) -> int:
    sizes = [int(a) for a in (argv if argv is not None else sys.argv[1:])]
    results = {}
    for n in sizes or (100_000, 1_000_000):
        res = compare(n)
        results[n] = res
        for name, r in res.items():
            print(f"{name} at {n} spins: native {r['native_s']:.4f} s, "
                  f"numpy {r['numpy_s']:.4f} s "
                  f"({r['numpy_s'] / r['native_s']:.1f}x), "
                  f"{'same' if r['same'] else 'DIFFERENT'} arrays "
                  f"[host: {os.cpu_count()} CPUs]", flush=True)
    print(json.dumps({"cpus": os.cpu_count(), "seconds": results}))
    return 0 if all(r["same"] for res in results.values()
                    for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
