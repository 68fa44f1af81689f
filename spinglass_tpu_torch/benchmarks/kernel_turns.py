"""Two checkouts' K1, K2, K3 and K4 timed in turns on one GPU.

    python -m spinglass_tpu_torch.benchmarks.kernel_turns PARENT_DIR

times the dense sweep (``FusedSweep``, SK glass, beta = 1, Philox mode) at
N=4096 x R=1024 with blocks 128 and 256 and at N=512 x R=256, the sparse
sweep (``SparseKernels.single_sweep``, the 10k bench graph) at R = 128, 256
and 1024, the threshold kernel (``SparseKernels.thresholds``) at [10240,
4096] and 1024, and the fused accept at [10240, 4096] and 128 on int8
spins: K4 alone on precomputed fields over one sweep's colours
(``SparseKernels.accept``) and the whole fused sweep
(``SortedSparseTEngine._sweep_fused``: whatever computes the fields, plus
K4), in the order parent, this checkout, this checkout,
parent: one process per turn, each building its own kernels, all on the
card this command runs on. PARENT_DIR is the root of another checkout of
the repository unpacked inside this one (``git archive`` of the parent
commit into a git-ignored directory), so that what it builds stays under
this checkout; a directory elsewhere is refused. Prints one JSON line per
turn and a summary; times are CUDA-event microseconds per sweep. The worker
uses only what both checkouts have.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

DENSE = ((4096, 1024, 128), (4096, 1024, 256), (512, 256, 128))
SPARSE_R = (128, 256, 1024)
WIDE_R = (4096, 128)


def worker() -> dict:
    """Times this process's package (the first entry of sys.path)."""
    import numpy as np
    import torch

    from spinglass_tpu_torch.benchmarks import headline
    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem, random_spins
    from spinglass_tpu_torch.kernels import metropolis_cuda as mc
    from spinglass_tpu_torch.kernels import sparse as sp
    from spinglass_tpu_torch.kernels.sparse import SortedSparseTEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed(fn, reps):
        for _ in range(3):
            fn()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e3 / reps

    out = {"card": headline.device_description(), "dense": {}, "sparse": {},
           "thresholds": {}, "accept": {}}
    problems = {}
    for n, r, block in DENSE:
        if n not in problems:
            j = topology.fully_connected(n, dist="gaussian",
                                         scale=1.0 / np.sqrt(n), seed=42)
            problems[n] = IsingProblem.from_dense(j, device="cuda")
        p = problems[n]
        fused = mc.FusedSweep(p, block_size=block)
        s = random_spins(gen, (r, p.n_padded),
                         p.active_mask).t().contiguous().cuda()
        beta = torch.ones(r, device="cuda")
        out["dense"][f"{n}x{r} B={block}"] = timed(
            lambda: fused(s, beta, 12345), 30)
    ell = headline.sparse_bench_problem()
    eng = SortedSparseTEngine(ell, accept_kernel="single")
    for r in SPARSE_R:
        s = eng.to_layout(random_spins(gen, (r, ell.n_padded),
                                       ell.active_mask).cuda())
        beta = torch.ones(r, device="cuda")
        out["sparse"][f"[{eng.n_sorted}, {r}]"] = timed(
            lambda: eng.kernels.single_sweep(s, beta, seed=7), 200)
    for r in (4096, 1024):
        beta = torch.ones(r, device="cuda")
        out["thresholds"][f"[{eng.n_sorted}, {r}]"] = timed(
            lambda: eng.kernels.thresholds(beta, 11, r), 100)
    eng = SortedSparseTEngine(ell, accept_kernel="fused")
    for r in WIDE_R:
        s = eng.to_layout(random_spins(gen, (r, ell.n_padded),
                                       ell.active_mask).cuda())
        beta = torch.ones(r, device="cuda")
        fields = [(off, sp._colour_fields(s, bs)) for off, _, bs in eng.groups]
        de = torch.zeros(r, device="cuda")
        cnt = torch.zeros(r, dtype=torch.int32, device="cuda")

        def given_fields():
            for off, f in fields:
                eng.kernels.accept(f, s, off, beta, 11, de, cnt)

        shape = f"[{eng.n_sorted}, {r}]"
        out["accept"][f"K4 on given fields, one sweep {shape}"] = timed(
            given_fields, 20)
        out["accept"][f"fused sweep {shape}"] = timed(
            lambda: eng._sweep_fused(s, beta, 11), 20)
    return out


def main(argv) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if argv[:1] == ["--worker"]:
        print(json.dumps(worker()))
        return 0
    if len(argv) != 1 or not os.path.isdir(
            os.path.join(argv[0], "spinglass_tpu_torch")):
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.realpath(argv[0])
    if os.path.commonpath([parent, os.path.realpath(here)]) != \
            os.path.realpath(here) or parent == os.path.realpath(here):
        print(f"PARENT_DIR must lie inside {here}", file=sys.stderr)
        return 2
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "sys.argv = [sys.argv[2], '--worker']; "
            "import runpy; runpy.run_path(sys.argv[0], run_name='__main__')")
    turns = []
    for label, root in (("parent", parent), ("change", here),
                        ("change", here), ("parent", parent)):
        res = subprocess.run(
            [sys.executable, "-c", code, root, os.path.abspath(__file__)],
            cwd=root, capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        turn = json.loads(res.stdout.strip().splitlines()[-1])
        turns.append((label, turn))
        print(json.dumps({"turn": label, **turn}))
    for kind in ("dense", "sparse", "thresholds", "accept"):
        for shape in turns[0][1][kind]:
            old = [t[kind][shape] for lab, t in turns if lab == "parent"]
            new = [t[kind][shape] for lab, t in turns if lab == "change"]
            print(f"{kind} {shape}: parent {old[0]:.1f} / {old[1]:.1f}, change "
                  f"{new[0]:.1f} / {new[1]:.1f} us "
                  f"[{turns[0][1]['card']}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
