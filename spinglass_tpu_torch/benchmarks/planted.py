"""Planted-ground-state instances and time-to-target-energy measurement.

The counterpart of ``spinglass_tpu.benchmarks.planted``; the instance
generator and its hash are copies, so the same spec gives the same instance
(and the same sha256) in both packages.

Gauge planting: a random connected graph with positive coupling magnitudes
|J_ij| and a random planted state s*; J_ij = |J_ij| s*_i s*_j satisfies every
bond at s*, so E0 = -sum_{i<j} |J_ij| is the exact ground energy.
``frustration`` > 0 flips that fraction of bond signs afterwards: the
instance becomes a genuine glass and e0 (the planted state's energy) only an
upper bound on the ground energy.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from spinglass_tpu_torch.anneal import graphs
from spinglass_tpu_torch.utils.profiling import global_profiler


@dataclass(frozen=True)
class PlantedInstance:
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    s_star: np.ndarray          # planted state [N]
    e0: float                   # its energy (the exact ground energy when
    # frustration == 0)
    n_spins: int
    frustration: float


def planted_gauge_coo(n_spins: int, avg_degree: float = 6.0, seed: int = 0,
                      frustration: float = 0.0,
                      magnitude: str = "uniform") -> PlantedInstance:
    """Symmetric COO (both directions) planted instance.

    magnitude: "uniform" |J| ~ U(0.5, 1.5) or "ones" |J| = 1 (+-J gauge
    glass)."""
    rng = np.random.default_rng(seed)
    m = int(n_spins * avg_degree / 2)
    # m random edges plus a chain backbone, so no spin floats free
    backbone = np.stack([np.arange(n_spins - 1), np.arange(1, n_spins)], 1)
    extra = rng.integers(0, n_spins, size=(m, 2))
    extra = extra[extra[:, 0] != extra[:, 1]]
    edges = np.concatenate([backbone, extra])
    edges = np.unique(np.sort(edges, axis=1), axis=0)

    if magnitude == "uniform":
        mag = rng.uniform(0.5, 1.5, size=len(edges))
    elif magnitude == "ones":
        mag = np.ones(len(edges))
    else:
        raise ValueError(magnitude)

    s_star = rng.choice([-1.0, 1.0], size=n_spins)
    vals = mag * s_star[edges[:, 0]] * s_star[edges[:, 1]]
    if frustration > 0:
        flip = rng.random(len(edges)) < frustration
        vals = np.where(flip, -vals, vals)
    e0 = float(-np.sum(vals * s_star[edges[:, 0]] * s_star[edges[:, 1]]))

    rows = np.concatenate([edges[:, 0], edges[:, 1]])
    cols = np.concatenate([edges[:, 1], edges[:, 0]])
    vals2 = np.concatenate([vals, vals])
    return PlantedInstance(rows=rows, cols=cols, vals=vals2,
                           s_star=s_star, e0=e0, n_spins=n_spins,
                           frustration=frustration)


def instance_hash(inst: PlantedInstance) -> str:
    """sha256 over rows.astype(int64) + cols.astype(int64) +
    vals.astype(float64) bytes: ties a recorded energy to the instance."""
    import hashlib

    h = hashlib.sha256()
    h.update(np.ascontiguousarray(inst.rows.astype(np.int64)).tobytes())
    h.update(np.ascontiguousarray(inst.cols.astype(np.int64)).tobytes())
    h.update(np.ascontiguousarray(inst.vals.astype(np.float64)).tobytes())
    return h.hexdigest()


@graphs.serialized
def time_to_target(problem, target_energy: float, cfg=None,
                   rel_gap: float = 1e-3, max_sweeps: int = 20000,
                   generator=None, seeds=None) -> dict:
    """Wall-clock until PT's best energy reaches
    target + rel_gap * |target| (energies are negative).

    Each run starts from a fresh ``pt.init_state`` and runs super-steps
    until the best energy is at or below the threshold, or ``max_sweeps``.
    The JAX version checks the target on the device after every super-step
    inside one while-loop dispatch; here the super-step is captured once
    per (problem object, cfg) (``pt.capture_super_step``, kept in
    ``graphs.PT_CACHE``; its warm-up builds and loads the kernels before any
    timing) and shared by the seeds and the calls: each seed's fresh state
    is copied into the captured state, and each replay is followed by one
    4-byte read of the best energy through a pinned buffer and an event (the
    only wait of a run). The check has the JAX granularity, one super-step.

    ``seeds``: optional ints; one run per seed (a fresh generator each), the
    median-by-seconds run reported at the top level and every run under
    "per_seed". Without seeds, one run with ``generator`` (or cfg.seed).
    Returns seconds, sweeps used and whether the target was hit."""
    from spinglass_tpu_torch.anneal import pt as pt_mod

    cfg = cfg or pt_mod.PTConfig(n_replicas=16, exchange_interval=10,
                                 min_temp=0.1, max_temp=5.0)
    threshold = target_energy + rel_gap * abs(target_energy)
    max_super = max(1, max_sweeps // cfg.exchange_interval)
    dev = problem.device

    if seeds is not None:
        gens = [torch.Generator().manual_seed(int(s)) for s in seeds]
    else:
        gens = [generator if generator is not None
                else torch.Generator().manual_seed(cfg.seed)]

    key = ("time_to_target", graphs.config_key(cfg))
    entry = graphs.PT_CACHE.get(problem, key)
    if entry is None:
        super_step, _, engine = pt_mod.make_pt_step(problem, cfg)

        def best_of(st):
            st, stats = super_step(st)
            return st, stats["best_energy"]

        captured = pt_mod.capture_super_step(
            best_of, pt_mod.init_state(
                problem, cfg, torch.Generator().manual_seed(0), engine))
        graphs.PT_CACHE.put(problem, key, (engine, captured))
    else:
        engine, captured = entry
    read = graphs.HostRead()
    runs = []
    for gen in gens:
        with global_profiler.phase("ttt.solve"):
            with global_profiler.phase("ttt.start"):
                captured.load(graphs.device_counter(
                    pt_mod.init_state(problem, cfg, gen, engine)))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            n_super, best = 0, float("inf")
            while best > threshold and n_super < max_super:
                out = captured.replay(gen)
                n_super += 1
                best = min(best, float(read([out])[0]))  # 4-byte read
            elapsed = time.perf_counter() - t0
        runs.append({
            "seconds": elapsed,
            "sweeps": n_super * cfg.exchange_interval,
            "best_energy": best,
            "hit": best <= threshold,
        })

    med = sorted(runs, key=lambda r: r["seconds"])[len(runs) // 2]
    out = {
        **med,
        "target_energy": target_energy,
        "threshold": threshold,
        "n_replicas": cfg.n_replicas,
        "engine": engine.name,
    }
    if seeds is not None:
        out["seeds"] = [int(s) for s in seeds]
        out["per_seed"] = runs
        out["seconds_min"] = min(r["seconds"] for r in runs)
        out["seconds_max"] = max(r["seconds"] for r in runs)
        out["all_hit"] = all(r["hit"] for r in runs)
    return out
