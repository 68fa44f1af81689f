"""Time-to-target solves: ``spinglass_tpu_torch.benchmarks.planted
.time_to_target`` called back to back, one fresh seed each: parallel
tempering from random spins until the best energy lies within the
configuration's relative gap of its target, or the sweep cap.

Parameters: ``n_replicas``, ``exchange_interval``, ``min_temp``,
``max_temp`` of the ``PTConfig``; the target, gap and cap are the
instance's record. ``pool`` and ``pool_seed`` fix the set of solves: the
solve seeds are ``pool`` seeds drawn from ``pool_seed``, the same for every
run, and the run's seed orders them (a fresh order each time round). How
long a solve takes depends on its seed, so a set of its own in every run
would change the work from run to run; a fixed set in a run's own order
keeps it and still varies what each window holds.

A solve reports its seconds, sweeps, best energy and whether it hit. It
returns no spins, so after each solve the benchmark reads the best replica's
best spins from the captured state that ``time_to_target`` keeps
(``graphs.PT_CACHE``), and every replica's for the solves that the seed
samples (and the last).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import program
from portbench.reference import energy, judge as J

SAMPLE_EVERY = 8


def _config(p: dict):
    from spinglass_tpu_torch.anneal import pt

    return pt.PTConfig(n_replicas=p["n_replicas"],
                       exchange_interval=p["exchange_interval"],
                       min_temp=p["min_temp"], max_temp=p["max_temp"])


def prepare(ctx):
    """The problem, the configuration and one solve on a seed of its own
    (it builds the kernels and captures the super-step)."""
    t = ctx.instance["target"]
    r = SimpleNamespace(ctx=ctx, n=ctx.instance["n"], target=t,
                        problem=program.problem(ctx.instance, ctx.device),
                        config=_config(ctx.params), last=None)
    r.threshold = t["energy"] + t["rel_gap"] * abs(t["energy"])
    _solve(r, ctx.job_seed(0, "warm-up"))
    return r


def _solve(r, seed: int) -> dict:
    from spinglass_tpu_torch.benchmarks import planted

    return planted.time_to_target(
        r.problem, r.target["energy"], r.config, rel_gap=r.target["rel_gap"],
        max_sweeps=r.target["max_sweeps"],
        generator=torch.Generator().manual_seed(seed))


def _pool_seed(ctx, i: int) -> int:
    """The solve seed of job ``i``: member perm[i % pool] of the fixed
    pool, perm the run's order for this time round."""
    from portbench.harness import derived_seed

    size = ctx.params["pool"]
    order = torch.randperm(size, generator=torch.Generator().manual_seed(
        ctx.job_seed(i // size, "order")))
    return derived_seed(ctx.params["pool_seed"], "solve",
                        int(order[i % size]))


def _state(r):
    from spinglass_tpu_torch.anneal import graphs

    engine, captured = graphs.PT_CACHE.get(
        r.problem, ("time_to_target", graphs.config_key(r.config)))
    return engine, captured.state


def job(r, i: int) -> dict:
    from spinglass_tpu_torch.anneal.engines import best_row

    ctx = r.ctx
    t0 = time.perf_counter()
    out = _solve(r, _pool_seed(ctx, i))
    seconds = time.perf_counter() - t0
    engine, st = _state(r)
    best = torch.argmin(st.best_energy)
    rec = {"seconds": seconds, "sweeps": out["sweeps"], "hit": out["hit"],
           "best_energy": out["best_energy"],
           "best_row": best_row(engine, st.best_spins, best)[: r.n].to(
               torch.int8),
           "replica_best": st.best_energy.clone(),
           "spins": engine.from_layout(st.best_spins)[:, : r.n].to(torch.int8)}
    if r.last is not None and not r.last["sampled"]:
        del r.last["spins"], r.last["replica_best"]
    rec["sampled"] = i == 0 or ctx.job_seed(i, "sample") % SAMPLE_EVERY == 0
    r.last = rec
    return rec


def end_to_end(records: list, window_s: float) -> dict:
    secs = np.asarray([x["seconds"] for x in records])
    return {"solves_per_s": len(records) / window_s,
            "tts_p90_s": float(np.percentile(secs, 90))}


def counts(records: list) -> dict:
    return {"jobs": len(records), "sweeps": sum(x["sweeps"] for x in records)}


def judge(r, records: list, ctx):
    """(checks, failed answers); see ``sa_jobs.judge``. Every solve's best
    spins are judged against its reported best energy and the target;
    sampled solves' every replica against its tracked best energy."""
    threshold = r.threshold
    del r.problem
    program.free_captured()
    inst, lim, dev = ctx.instance, ctx.workload["limits"], ctx.device
    ref = energy.Couplings(inst, dev)
    bf16 = ctx.control == "reference_bf16"
    low = energy.Couplings(inst, dev, torch.float32, True) if bf16 else None
    rows = torch.stack([x["best_row"] for x in records]).to(dev)
    e_rows = ref.energies(rows).cpu()
    claimed = (low.energies(rows).cpu() if bf16 else
               torch.tensor([x["best_energy"] for x in records],
                            dtype=torch.float64))
    sigma = ref.random_sigma()
    gaps = J.rel_gap(claimed, e_rows, sigma)
    target = J.above(e_rows, threshold)
    missed = torch.tensor([not x["hit"] for x in records])
    not_min = torch.zeros(len(records), dtype=torch.float64)
    unmoved = torch.zeros(len(records), dtype=torch.float64)
    band = -J.UNMOVED_SIGMAS * sigma
    for k, x in enumerate(records):
        if "spins" not in x:
            continue
        s = x["spins"].to(dev)
        e_all = ref.energies(s).cpu()
        rep = low.energies(s).cpu() if bf16 else x["replica_best"].cpu()
        gaps[k] = max(gaps[k], J.rel_gap(rep, e_all, sigma).max())
        not_min[k] = abs(x["best_energy"] - float(x["replica_best"].min()))
        unmoved[k] = float((e_all > band).sum())
    bad = ((gaps > lim["energy_gap"]) | (target > lim["target_gap"])
           | (not_min > lim["best_not_min"]) | (unmoved > 0) | missed)
    checks = {"energy_gap": J.check(gaps.max(), lim["energy_gap"]),
              "best_not_min": J.check(not_min.max(), lim["best_not_min"]),
              "target_gap": J.check(target.max(), lim["target_gap"]),
              "unmoved": J.check(unmoved.max(), 0),
              "missed": J.check(missed.sum(), 0)}
    return checks, int(bad.sum())
