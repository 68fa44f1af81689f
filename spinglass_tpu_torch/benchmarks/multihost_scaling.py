"""Measured multi-process scaling of the sharded PT path (gloo on the CPU).

Runs the SAME per-process sharded-PT workload (one gloo rank per process
holding 4 replicas, via distributed._multihost_worker) first as ONE
process, then as TWO processes joined by ``torch.distributed`` over
localhost, and writes a scaling_report comparing the two to
MULTIHOST_scaling_torch.json (or the path given). The repo's
MULTIHOST_scaling.json is the JAX package's record and is not written.

CAVEAT (recorded in the artifact): the cross-process boundary here is
localhost TCP between CPU ranks — it checks the code path and the
per-super-step collective payload (one all-gather of 5 x R float32), NOT
NVLink or network bandwidth.

Usage: python -m spinglass_tpu_torch.benchmarks.multihost_scaling [out.json]
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time


def _worker_n_super() -> int:
    from spinglass_tpu_torch.distributed._multihost_worker import N_SUPER

    return N_SUPER


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_procs(nproc: int, outdir: str, n_spins: int,
               timeout: float = 300.0, device: str = "cpu") -> list:
    """Spawn nproc workers, wait, return their per-process reports.
    ``timeout`` bounds the wait for each worker; a worker that fails or
    hangs takes its siblings down with it. On ``device`` "cuda" worker i
    drives card i (NCCL).

    Each CPU worker is PINNED to its own CPU core (taskset): without pinning, a
    2-core box runs the 1-process baseline on both cores but oversubscribes
    them 2x in the 2-process run, and the 'scaling efficiency' measures CPU
    contention instead of the cross-process design (measured: 0.42 at
    n=512 unpinned on 2 cores). Pinned, every 'host' is one core in both
    runs — an apples-to-apples per-host workload."""
    env = dict(os.environ)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)             # the workers get theirs as arguments
    ncores = os.cpu_count() or 1
    pin = ncores >= nproc and device == "cpu"
    port = _free_port()
    procs = [
        subprocess.Popen(
            (["taskset", "-c", str(i % ncores)] if pin else [])
            + [sys.executable, "-m",
               "spinglass_tpu_torch.distributed._multihost_worker",
               str(i), str(nproc), str(port), outdir, str(n_spins), device],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(nproc)
    ]
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        # a failed or hung worker must not orphan its siblings: they sit
        # forever in a collective with a dead peer, pinned to a core and
        # holding the coordinator port
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate()[0].decode(errors="replace") for p in procs]
    for i, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError("\n".join(
                f"worker {k} rc={q.returncode}:\n{outs[k][-2000:]}"
                for k, q in enumerate(procs)))
    reports = []
    for i in range(nproc):
        with open(os.path.join(outdir, f"proc{i}.json")) as f:
            reports.append(json.load(f))
    return reports


def measure(n_spins: int = 512, tmpdir: str | None = None,
            device: str = "cpu", nproc: int = 2) -> dict:
    """1-process baseline then an ``nproc``-process run; returns the
    scaling report.

    Accounting: every rank times the same super-steps, so its
    flips_per_sec is the GLOBAL rate; the per-HOST contribution is
    global/process_count (each rank sweeps its replica shard).
    Efficiency = sum(per-host rates at N=nproc) / (nproc x the 1-process
    rate) — the 1-process run sweeps the same per-rank workload (4 replicas
    on the CPU, 1024 on a card). On the CPU n_spins defaults to 512: at 64
    spins the per-super-step collective latency over localhost TCP dwarfs
    the sweep and the number measures only the transport, not the design.
    On "cuda" the kernels are built here first, once, for every worker."""
    import tempfile

    from spinglass_tpu_torch.distributed.multihost import scaling_report

    if device == "cuda":
        from spinglass_tpu_torch.kernels import build

        build.build_many(["metropolis_sweep"])
    with tempfile.TemporaryDirectory(dir=tmpdir) as d1:
        base = _run_procs(1, d1, n_spins, device=device)[0]
    with tempfile.TemporaryDirectory(dir=tmpdir) as d2:
        two = _run_procs(nproc, d2, n_spins, device=device)

    rep = scaling_report(
        [r["flips_per_sec_per_process"] for r in two],
        baseline_rate=base["flips_per_sec_per_process"])
    if device == "cuda":   # the replays alone, without the start state
        rep["replay_efficiency"] = _replay_efficiency(base, two)
    rep.update({
        "workload": {
            "n_spins": n_spins,
            "devices_per_process": base["local_devices"],
            "replicas_per_device": base["n_replicas"]
            // base["local_devices"],
            "backend": "nccl (cuda)" if device == "cuda" else "gloo (CPU)",
            "engine": base["engine"],
        },
        "single_process": {k: base[k] for k in
                           ("flips_per_sec", "seconds", "n_replicas")},
        "two_process": [
            {k: r[k] for k in ("process", "flips_per_sec",
                               "flips_per_sec_per_process", "seconds",
                               "n_replicas", "best_energy", "checks",
                               "device")} for r in two],
        "caveat": ("NCCL between the cards of one host" if device == "cuda"
                   else "localhost TCP between gloo ranks on one "
                   "machine's CPU — checks the torch.distributed code path "
                   "and the O(R) exchange payload, not NVLink or network "
                   "bandwidth"),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    })
    return rep


def _replay_efficiency(base: dict, runs: list) -> float:
    """Efficiency of the captured super-step's replays alone: the ranks'
    per-rank replay rates over N x the one-rank replay rate."""
    one = base["checks"]["replay_flips_per_sec"]
    per = [r["checks"]["replay_flips_per_sec"] / r["process_count"]
           for r in runs]
    return float(sum(per) / (len(per) * one)) if one else 0.0


def main() -> None:
    """``python -m spinglass_tpu_torch.benchmarks.multihost_scaling
    [out.json] [--device cpu|cuda] [--procs N]``: on the CPU 2 gloo ranks at
    n=512 and 2048, on the cards N NCCL ranks (one card each) at the SK
    glass's n=4096. Writes MULTIHOST_scaling_torch.json by default."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="MULTIHOST_scaling_torch.json")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--procs", type=int, default=2)
    args = ap.parse_args()
    sizes = (4096,) if args.device == "cuda" else (512, 2048)
    # two CPU sizes expose the overhead structure: a roughly constant
    # per-super-step transport latency against a sweep that grows with N
    runs = {n: measure(n_spins=n, device=args.device, nproc=args.procs)
            for n in sizes}
    summary = {
        "device": args.device,
        "processes": args.procs,
        "efficiency_by_n_spins": {str(n): runs[n]["efficiency"]
                                  for n in sizes},
        "per_super_step_overhead_seconds": {
            str(n): (runs[n]["two_process"][0]["seconds"]
                     - runs[n]["single_process"]["seconds"]) / _worker_n_super()
            for n in sizes},
        "interpretation": ("one all-gather of [5, R] float32 per "
                           "super-step; the residual per super-step is the "
                           "transport's latency, so efficiency rises with "
                           "the sweep's work. Read it on an idle machine: "
                           "other load inflates the multi-process run more "
                           "than the one-process run"),
        "runs": {str(n): runs[n] for n in sizes},
    }
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({"efficiency_by_n": summary["efficiency_by_n_spins"],
                      "out": args.out}))


if __name__ == "__main__":
    main()
