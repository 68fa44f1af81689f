"""Worker for the multi-process sharded-PT run (started by subprocess).

Each process is one rank: it brings up a ``torch.distributed`` group over
localhost (``multihost.initialize``), builds the replica mesh spanning
every process, and runs sharded parallel tempering across the process
boundary (``pt_sharded``) — the ``init_process_group`` + one all-gather per
super-step path that a multi-node run uses. The counterpart of the JAX
package's worker.

* device "cpu" (default): a gloo rank holding the 4 replicas that a JAX
  worker process holds on its 2 virtual devices; ``N_SUPER`` eager
  super-steps of the sharded step are timed after one to warm up;
* device "cuda": an NCCL rank on card ``process_id`` (LOCAL_RANK) holding
  1024 replicas of the SK glass (K1 at full width); ``pt_sharded.run`` of
  ``N_SUPER`` super-steps is called twice (the first captures) and the
  second is timed (the start state drawn on the host, the replays, the
  final read), then ``N_SUPER`` replays of its captured super-step alone
  (``checks["replay_seconds"]``). The rank checks its result: every chain's slots a
  permutation of the ladder, the best energy that of the best spins.

Usage: python -m spinglass_tpu_torch.distributed._multihost_worker \
           <process_id> <num_processes> <port> <out_dir> [n_spins] [device]
"""

import json
import os
import sys
import time

# timed super-steps per worker — benchmarks.multihost_scaling divides by
# this to report per-super-step overhead, so it must be THE constant
N_SUPER = 10
REPLICAS_PER_RANK = 4           # on the CPU
REPLICAS_PER_RANK_CUDA = 1024   # on the card: K1's full width


def _cpu_run(problem, nproc, n):
    import torch

    from spinglass_tpu_torch.anneal.pt import PTConfig
    from spinglass_tpu_torch.distributed import pt_sharded

    cfg = PTConfig(n_replicas=REPLICAS_PER_RANK * nproc, exchange_interval=5,
                   use_kernel="never", min_temp=0.2, max_temp=5.0, seed=0)
    step, init, _, engine, _ = pt_sharded.make_sharded_pt_step(
        problem, cfg, pt_sharded.make_mesh("cpu"))
    state = init(torch.Generator().manual_seed(0))
    state, stats = step(state)                   # warm
    t0 = time.perf_counter()
    for _ in range(N_SUPER):
        state, stats = step(state)
    dt = time.perf_counter() - t0
    # flips/dt is the GLOBAL rate (every rank times the same super-steps
    # over all n_replicas); this rank swept n_replicas / process_count of
    # them, its own contribution flips_per_sec_per_process — sum THOSE
    flips = N_SUPER * cfg.exchange_interval * cfg.n_replicas * n
    return cfg, engine.name, dt, flips, float(stats["best_energy"]), {}


def _cuda_run(problem, nproc, n):
    import numpy as np

    from spinglass_tpu_torch.anneal.pt import PTConfig
    from spinglass_tpu_torch.core.energy import energy
    from spinglass_tpu_torch.distributed import pt_sharded

    cfg = PTConfig(n_replicas=REPLICAS_PER_RANK_CUDA * nproc,
                   n_sweeps=N_SUPER * 10, exchange_interval=10,
                   sweep_method="blocked", min_temp=0.2, max_temp=3.0, seed=0)
    mesh = pt_sharded.make_mesh("cuda")
    first = pt_sharded.run(problem, cfg, mesh)
    res = pt_sharded.run(problem, cfg, mesh)
    # the replays alone (the sweeps and the all-gather; no start state, no
    # final read): N_SUPER more replays of the cached captured super-step
    import torch

    from spinglass_tpu_torch.anneal import graphs

    step = pt_sharded.SHARDED_CACHE.get(
        problem, ("run", graphs.config_key(cfg), id(mesh)))[4]
    gen = torch.Generator().manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_SUPER):
        step.replay(gen)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    del step
    slots = np.asarray(res.metadata["slot_trajectory"])[-1]
    perm_ok = all(np.array_equal(np.sort(c), np.arange(cfg.n_replicas))
                  for c in slots.reshape(cfg.n_chains, cfg.n_replicas))
    full = np.ones((1, problem.n_padded), np.float32)
    full[0, :n] = res.best_spins
    e_best = float(energy(problem, torch.as_tensor(full, device="cuda"))[0])
    checks = {
        "slots_permutation": bool(perm_ok),
        "best_energy_of_best_spins": bool(
            abs(e_best - res.best_energy) <= 1e-4 * abs(res.best_energy)),
        "repeat_equal": bool(first.best_energy == res.best_energy and
                             np.array_equal(first.energy_history,
                                            res.energy_history)),
        "kernel_launches": res.metadata["kernel_launches"],
        "replay_seconds": replay_s,
        "replay_flips_per_sec": res.n_sweeps * cfg.n_replicas * n / replay_s,
    }
    flips = res.n_sweeps * cfg.n_replicas * n
    return (cfg, res.metadata["engine"], res.total_time, flips,
            res.best_energy, checks)


def main() -> None:
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    outdir = sys.argv[4]
    device = sys.argv[6] if len(sys.argv) > 6 else "cpu"
    n = int(sys.argv[5]) if len(sys.argv) > 5 else (
        4096 if device == "cuda" else 64)

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem
    from spinglass_tpu_torch.distributed import multihost

    if device == "cuda":
        os.environ["LOCAL_RANK"] = str(pid)
    info = multihost.initialize(coordinator_address=f"localhost:{port}",
                                num_processes=nproc, process_id=pid,
                                device=device, timeout_s=120)
    assert info["process_count"] == nproc, info
    try:
        dev = multihost.device_of_group()
        j = topology.fully_connected(n, dist="gaussian",
                                     scale=1.0 / np.sqrt(n), seed=0)
        problem = IsingProblem.from_dense(j, device=dev)
        run = _cuda_run if device == "cuda" else _cpu_run
        cfg, engine, dt, flips, best, checks = run(problem, nproc, n)
        out = {
            "process": pid,
            "process_count": info["process_count"],
            "global_devices": info["global_devices"],
            "local_devices": info["local_devices"],
            "device": str(dev),
            "n_replicas": cfg.n_replicas,
            "flips_per_sec": flips / dt,
            "flips_per_sec_per_process": flips / dt / info["process_count"],
            "seconds": dt,
            "best_energy": best,
            "finite": bool(np.isfinite(best)),
            "engine": engine,
            "checks": checks,
        }
        if device == "cuda":
            from spinglass_tpu_torch.benchmarks.headline import (
                device_description)

            out["card"] = device_description()
        with open(os.path.join(outdir, f"proc{pid}.json"), "w") as f:
            json.dump(out, f)
        print(f"proc{pid} ok: {out['flips_per_sec']:.3g} flips/s", flush=True)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
