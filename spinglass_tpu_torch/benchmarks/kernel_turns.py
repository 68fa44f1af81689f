"""Two checkouts' kernels timed in turns on one GPU.

    python -m spinglass_tpu_torch.benchmarks.kernel_turns PARENT_DIR [--sw]
    python -m spinglass_tpu_torch.benchmarks.kernel_turns PARENT_DIR --dense
    python -m spinglass_tpu_torch.benchmarks.kernel_turns PARENT_DIR --dense --rounds 5

times the dense sweep (``FusedSweep``, SK glass, beta = 1, Philox mode) at
N=4096 x R=1024 with blocks 128 and 256 and at N=512 x R=256, its variants
K5, K6 (2 and 4 chains) and K7 at N=4096 x R=1024, blocks 128 and 256
(``--dense``: these alone), the sparse
sweep (``SparseKernels.single_sweep``, the 10k bench graph) at R = 128, 256
and 1024, the threshold kernel (``SparseKernels.thresholds``) at [10240,
4096] and 1024, and the fused accept at [10240, 4096], 128 and 16 on int8
spins: K4 alone on precomputed fields over one sweep's colours
(``SparseKernels.accept``) and the whole fused sweep
(``SortedSparseTEngine._sweep_fused``: whatever computes the fields, plus
K4), and the Swendsen-Wang sweep on the TTT instance at 128 and 16 replicas
(``sw_worker``: one SW sweep, C1, C2 where the checkout has it, the captured
PT super-step with and without cluster_moves=1; ``--sw`` times that alone),
in the order parent, this checkout, this checkout,
parent (``--rounds N``: that order N times): one process per turn, each building its own kernels, all on the
card this command runs on. Each kernel is timed with its seed by value and,
where the checkout has seed slots, with the seed in device memory (the mode
the captured drivers launch); the summary gives each mode's change against
the parent's by-value time, and with more than two turns a side the
medians and quartiles of both. PARENT_DIR is the root of another checkout of
the repository unpacked inside this one (``git archive`` of the parent
commit into a git-ignored directory), so that what it builds stays under
this checkout; a directory elsewhere is refused. Prints one JSON line per
turn and a summary; times are CUDA-event microseconds per sweep, around
calls launched from the host ("events") and around one replay of a CUDA
graph of the same calls ("graph": the device alone, which the host cannot
keep busy at the narrow shapes). The worker
uses only what both checkouts have.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

DENSE = ((4096, 1024, 128), (4096, 1024, 256), (512, 256, 128))
VARIANTS = (("K5", dict(pipelined=True)), ("K6x2", dict(interleave=2)),
            ("K6x4", dict(interleave=4)), ("K7", dict(folded=True)))
SPARSE_R = (128, 256, 1024)
WIDE_R = (4096, 128, 16)


def sw_worker(timed, res) -> None:
    """The Swendsen-Wang sweep on the TTT instance at 128 and 16 replicas
    (random spins at the TTT config's ladder's betas): one SW sweep (eager, drawing its own numbers: "events"; on given draws
    and, where the package has C2, from a seed slot: "graph"), C1 on one
    sweep's bonds (labels alone where the package has no flip in C1, labels
    and flip where it has), C2 where the package has it, and the captured
    PT super-step (``pt.run``'s) with and without cluster_moves=1, by CUDA
    events around one replay ("events": a replay is one graph launch)."""
    import dataclasses

    import torch

    from spinglass_tpu_torch.anneal import graphs, pt
    from spinglass_tpu_torch.benchmarks.headline import (ttt_config,
                                                         ttt_instance)
    from spinglass_tpu_torch.core.cluster import SwendsenWang
    from spinglass_tpu_torch.kernels import metropolis_cuda as mc

    ttt, _ = ttt_instance()
    sw = SwendsenWang(ttt)
    n, k = sw._idx.shape
    new = hasattr(sw, "bonds")          # C2, and C1 with its flip
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for r in (128, 16):
        gen = torch.Generator().manual_seed(r)
        s = torch.where(torch.rand(r, n, generator=gen) < 0.5, -1.0, 1.0)
        s = torch.where(sw.ell.active_mask.cpu()[None] > 0, s, 1.0)
        s = s.cuda().contiguous()
        beta = 1.0 / torch.as_tensor(pt.temperature_ladder(
            dataclasses.replace(ttt_config(), n_replicas=r)),
            dtype=torch.float32, device="cuda")
        shape = f"[{r}, {n}]"
        draws = (mc.sw_philox_draws(7, r, n, k, "cuda") if new
                 else sw.draws(r, gen, "cuda"))
        timed(lambda: sw.sweep(s, beta, gen), 10, res, "sw",
              f"SW sweep, eager with its draws {shape}", in_graph=False)
        timed(lambda: sw.sweep_with_draws(s, beta, *draws), 10, res, "sw",
              f"SW sweep, draws given {shape}", events=False)
        if new:
            slot = torch.tensor([7], dtype=torch.int64, device="cuda")[0]
            timed(lambda: sw._sweep(s, beta, seed=slot), 10, res, "sw",
                  f"SW sweep, seed slot {shape}", events=False)
            masks, init = sw.bonds(s, beta, seed=slot)
            timed(lambda: sw.bonds(s, beta, seed=slot), 20, res, "sw",
                  f"C2 Philox {shape}", events=False)
            timed(lambda: sw.labeller.flip(sw._idx, masks, init, s,
                                           seed=slot), 20, res, "sw",
                  f"C1 {shape}", events=False)
        else:
            got = {}
            real = sw.labeller

            def spy(idx, bond, init):
                got.update(idx=idx, bond=bond.clone(), init=init.clone())
                return real(idx, bond, init)

            sw.labeller = spy
            sw.sweep_with_draws(s, beta, *draws)
            sw.labeller = real
            timed(lambda: real(got["idx"], got["bond"], got["init"]), 20, res,
                  "sw", f"C1 {shape}", events=False)
        for cm in (0, 1):
            cfg = dataclasses.replace(ttt_config(), n_replicas=r,
                                      n_sweeps=100, cluster_moves=cm)
            pt.run(ttt, cfg)
            step = graphs.PT_CACHE.get(ttt, ("run", graphs.config_key(cfg)))[2]
            step.replay(gen)
            start.record()
            for _ in range(20):
                step.replay(gen)
            stop.record()
            stop.synchronize()
            key = f"PT super-step, cluster_moves={cm} {shape}"
            res["events"]["sw"][key] = start.elapsed_time(stop) * 1e3 / 20


def worker(sw_only: bool = False, dense_only: bool = False) -> dict:
    """Times this process's package (the first entry of sys.path): every
    kernel with its seed by value, and where the package has seed slots
    (``metropolis_cuda.seed_arg``) with the seed in device memory too; the
    Swendsen-Wang sweep once (``sw_worker``). ``sw_only``: that alone;
    ``dense_only``: the dense sweeps alone."""
    import numpy as np
    import torch

    from spinglass_tpu_torch.benchmarks import headline
    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem, random_spins
    from spinglass_tpu_torch.kernels import metropolis_cuda as mc
    from spinglass_tpu_torch.kernels import sparse as sp
    from spinglass_tpu_torch.kernels.sparse import SortedSparseTEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed(fn, reps, res, kind, key, events=True, in_graph=True):
        """us per call of ``fn``, by CUDA events around ``reps`` calls
        launched from the host ("events") and around one replay of a graph
        that captured ``reps`` calls ("graph": the device's time alone,
        where the host cannot keep a narrow kernel busy)."""
        for _ in range(3):
            fn()
        if events:
            start.record()
            for _ in range(reps):
                fn()
            stop.record()
            stop.synchronize()
            res["events"][kind][key] = start.elapsed_time(stop) * 1e3 / reps
        if not in_graph:
            return
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        res["graph"][kind][key] = start.elapsed_time(stop) * 1e3 / reps

    modes = ["value"] + (["slot"] if hasattr(mc, "seed_arg") else [])
    out = {"card": headline.device_description()}
    if sw_only:
        modes = []
        out["value"] = {how: {"sw": {}} for how in ("events", "graph")}
        sw_worker(timed, out["value"])
    problems = {}
    ell = None if dense_only else headline.sparse_bench_problem()
    for mode in modes:
        gen = torch.Generator().manual_seed(1)

        def seed(v):
            return (v if mode == "value" else
                    torch.tensor([v], dtype=torch.int64, device="cuda")[0])

        res = out[mode] = {how: {"dense": {}, "sparse": {}, "thresholds": {},
                                 "accept": {}, "sw": {}}
                           for how in ("events", "graph")}
        if mode == "value" and not dense_only:
            sw_worker(timed, res)
        for n, r, block in DENSE:
            if n not in problems:
                j = topology.fully_connected(n, dist="gaussian",
                                             scale=1.0 / np.sqrt(n), seed=42)
                problems[n] = IsingProblem.from_dense(j, device="cuda")
            p = problems[n]
            s = random_spins(gen, (r, p.n_padded),
                             p.active_mask).t().contiguous().cuda()
            beta = torch.ones(r, device="cuda")
            flags = [("K1", {})] + (list(VARIANTS) if n == 4096 else [])
            for label, kw in flags:
                fused = mc.FusedSweep(p, block_size=block, **kw)
                sd = seed(12345)
                timed(lambda: fused(s, beta, sd), 30 if label == "K1" else 10,
                      res, "dense", f"{label} {n}x{r} B={block}")
        if dense_only:
            continue
        eng = SortedSparseTEngine(ell, accept_kernel="single")
        for r in SPARSE_R:
            s = eng.to_layout(random_spins(gen, (r, ell.n_padded),
                                           ell.active_mask).cuda())
            beta = torch.ones(r, device="cuda")
            sd = seed(7)
            timed(lambda: eng.kernels.single_sweep(s, beta, seed=sd), 200,
                  res, "sparse", f"[{eng.n_sorted}, {r}]")
        for r in (4096, 1024):
            beta = torch.ones(r, device="cuda")
            sd = seed(11)
            timed(lambda: eng.kernels.thresholds(beta, sd, r), 100, res,
                  "thresholds", f"[{eng.n_sorted}, {r}]")
        eng = SortedSparseTEngine(ell, accept_kernel="fused")
        for r in WIDE_R:
            s = eng.to_layout(random_spins(gen, (r, ell.n_padded),
                                           ell.active_mask).cuda())
            beta = torch.ones(r, device="cuda")
            fields = [(off, sp._colour_fields(s, bs))
                      for off, _, bs in eng.groups]
            de = torch.zeros(r, device="cuda")
            cnt = torch.zeros(r, dtype=torch.int32, device="cuda")
            sd = seed(11)

            def given_fields():
                for off, f in fields:
                    eng.kernels.accept(f, s, off, beta, sd, de, cnt)

            shape = f"[{eng.n_sorted}, {r}]"
            timed(given_fields, 20, res, "accept",
                  f"K4 on given fields, one sweep {shape}")
            timed(lambda: eng._sweep_fused(s, beta, sd), 20, res, "accept",
                  f"fused sweep {shape}")
    return out


def main(argv) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if argv[:1] == ["--worker"]:
        print(json.dumps(worker(sw_only="--sw" in argv,
                                dense_only="--dense" in argv)))
        return 0
    rounds = 1
    if "--rounds" in argv[1:-1]:
        at = argv.index("--rounds")
        rounds = int(argv[at + 1])
        argv = argv[:at] + argv[at + 2:]
    extra = [a for a in argv[1:] if a in ("--sw", "--dense")]
    if len(argv) - len(extra) != 1 or rounds < 1 or not os.path.isdir(
            os.path.join(argv[0], "spinglass_tpu_torch")):
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.realpath(argv[0])
    if os.path.commonpath([parent, os.path.realpath(here)]) != \
            os.path.realpath(here) or parent == os.path.realpath(here):
        print(f"PARENT_DIR must lie inside {here}", file=sys.stderr)
        return 2
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "sys.argv = [sys.argv[2], '--worker'] + sys.argv[3:]; "
            "import runpy; runpy.run_path(sys.argv[0], run_name='__main__')")
    turns = []
    for label, root in (("parent", parent), ("change", here),
                        ("change", here), ("parent", parent)) * rounds:
        res = subprocess.run(
            [sys.executable, "-c", code, root, os.path.abspath(__file__),
             *extra],
            cwd=root, capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        turn = json.loads(res.stdout.strip().splitlines()[-1])
        turns.append((label, turn))
        print(json.dumps({"turn": label, **turn}))
    card = turns[0][1]["card"]
    for how in ("events", "graph"):
        for kind in ("dense", "sparse", "thresholds", "accept", "sw"):
            shapes = [sh for _, t in turns for sh in
                      t["value"][how].get(kind, {})]
            for shape in dict.fromkeys(shapes):
                old = [t["value"][how].get(kind, {}).get(shape)
                       for lab, t in turns if lab == "parent"]
                if None in old:   # the parent has no such entry
                    old = [float("nan")] * len(old)
                line = f"{how}: {kind} {shape}: parent {_times(old)}"
                for mode in ("value", "slot"):
                    new = [t[mode][how][kind][shape] for lab, t in turns
                           if lab == "change" and mode in t
                           and shape in t[mode][how].get(kind, {})]
                    if new:
                        line += (f", change ({mode}) {_times(new)} "
                                 f"({100 * (sum(new) / sum(old) - 1):+.1f}%)")
                print(f"{line} us [{card}]")
    return 0


def _times(ts) -> str:
    """Two turns' times as "a / b"; more as their median and quartiles."""
    if len(ts) <= 2:
        return " / ".join(f"{t:.1f}" for t in ts)
    q1, med, q3 = statistics.quantiles(ts, n=4)
    return f"median {med:.1f} (quartiles {q1:.1f}-{q3:.1f}, {len(ts)} turns)"


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
