"""Parallel-tempering runs: ``spinglass_tpu_torch.anneal.pt.run`` called back
to back, each job on a fresh generator seed, each doing its whole sweep
budget.

Parameters (the workload file's ``params``): ``n_replicas`` (the ladder's
slots), ``n_chains``, ``ladder``, ``min_temp``, ``max_temp``,
``update_rule``, ``exchange_interval``, ``n_sweeps``; ``measure_overlaps``
and ``j_dtype`` (a control) are passed only where the parameters name them,
so that a program without those fields still runs the cells that do not.
``replicas`` is the sweep's replica count, n_replicas x n_chains, which the
workload names as its ``replicas_param`` for the readers of a sweep's
kernels; it is checked and not passed on. A job's flips are n_sweeps x
n_replicas x n_chains x N.

A job's answer is what ``run`` returns: the best energy and its spins, every
replica's best energy, the per-slot energy of every super-step and, with
overlaps, the last super-step's q. After each job the benchmark reads the
final state from the captured super-step that ``run`` keeps
(``graphs.PT_CACHE``): the energies and slots, and for the jobs that the
seed samples (and the last) every replica's spins and best spins, so that
each reported energy and overlap is judged against its spins.

The check (``judge``) holds, for every cell: ``energy_gap``, ``best_not_min``,
``quality_gap`` (the best energy's spins above the instance's ground energy
or its estimate) and ``unmoved``; on a lattice instance also
``overlap_gap`` (the last q against the reference's q of the final spins
and slots) and ``thermal_gap`` (the mean energy per spin at each slot at or
above the workload's ``check.thermal_min_temp``, over the second half of
each job, against the reference's own chains at those temperatures, in
units of the ladder's energy step there: how many slots away the program's
energies lie).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import program
from portbench.reference import energy, judge as J

SAMPLE_EVERY = 8   # a job is sampled with probability 1 / SAMPLE_EVERY
OPTIONAL = ("measure_overlaps", "j_dtype")
FIELDS = ("n_replicas", "n_chains", "ladder", "min_temp", "max_temp",
          "update_rule", "exchange_interval", "n_sweeps")


def _config(p: dict):
    from spinglass_tpu_torch.anneal import pt

    if p.get("replicas", p["n_replicas"] * p["n_chains"]) != \
            p["n_replicas"] * p["n_chains"]:
        raise ValueError(f"replicas must be n_replicas x n_chains = "
                         f"{p['n_replicas'] * p['n_chains']}, got "
                         f"{p['replicas']}")
    return pt.PTConfig(**{k: p[k] for k in FIELDS},
                       **{k: p[k] for k in OPTIONAL if k in p})


def prepare(ctx):
    """The program's problem and configuration, and one job on a seed of
    its own: the first call builds the kernels and captures the
    super-step, so that no job of the window does."""
    r = SimpleNamespace(ctx=ctx, n=ctx.instance["n"],
                        problem=program.problem(ctx.instance, ctx.device),
                        config=_config(ctx.params), last=None)
    _run(r, ctx.job_seed(0, "warm-up"))
    return r


def _run(r, seed: int):
    from spinglass_tpu_torch.anneal import pt

    return pt.run(r.problem, r.config,
                  generator=torch.Generator().manual_seed(seed))


def _state(r):
    from spinglass_tpu_torch.anneal import graphs

    _, engine, step = graphs.PT_CACHE.get(
        r.problem, ("run", graphs.config_key(r.config)))
    return engine, step.state


def job(r, i: int) -> dict:
    ctx, cfg = r.ctx, r.config
    t0 = time.perf_counter()
    res = _run(r, ctx.job_seed(i))
    seconds = time.perf_counter() - t0
    engine, st = _state(r)
    md = res.metadata
    hist = np.asarray(md["slot_energy_history"], np.float64)   # [n_super, T]
    q = md.get("slot_overlap_history")
    rec = {"seconds": seconds, "sweeps": res.n_sweeps,
           "flips": res.n_sweeps * cfg.n_replicas * cfg.n_chains * r.n,
           "overlap_measurements": int(md.get("overlap_measurements", 0)),
           "best_energy": res.best_energy,
           "best_row": torch.as_tensor(res.best_spins[: r.n]).to(torch.int8),
           "replica_best": torch.as_tensor(res.replica_best_energy),
           "slot_energy": hist[hist.shape[0] // 2:].mean(axis=0),
           "overlap": None if q is None else np.asarray(q[-1]),
           "energy": st.energy.clone(), "slot": st.slot.clone(),
           "spins": engine.from_layout(st.spins)[:, : r.n].to(torch.int8),
           "best_spins": engine.from_layout(st.best_spins)[:, : r.n].to(
               torch.int8)}
    if r.last is not None and not r.last["sampled"]:
        del r.last["spins"], r.last["best_spins"]
    rec["sampled"] = i == 0 or ctx.job_seed(i, "sample") % SAMPLE_EVERY == 0
    r.last = rec
    return rec


def end_to_end(records: list, window_s: float) -> dict:
    return {"flips_per_s": sum(x["flips"] for x in records) / window_s}


def counts(records: list) -> dict:
    return {"jobs": len(records), "sweeps": sum(x["sweeps"] for x in records),
            "overlap_measurements": sum(x["overlap_measurements"]
                                        for x in records)}


def judge(r, records: list, ctx):
    """(checks, failed answers). Frees the program's captured state first.
    Control "reference_bf16": the energies are those that the reference
    computes on bfloat16 couplings (on the lattice, in bfloat16
    arithmetic), in the program's place."""
    cfg = r.config
    del r.problem
    program.free_captured()
    inst, lim, dev = ctx.instance, ctx.workload["limits"], ctx.device
    lat = inst.get("lattice")
    ref = energy.Couplings(inst, dev)
    if lat is not None:
        from portbench.reference import ea3d

        def exact(s):
            return ea3d.energies(lat["j"], ea3d.lattice(s.to(dev), lat["L"])).cpu()
    else:
        def exact(s):
            return ref.energies(s.to(dev)).cpu()
    bf16 = ctx.control == "reference_bf16"
    if lat is None:
        low = energy.Couplings(inst, dev, torch.float32, True).energies
    else:   # +-1 couplings are exact in bfloat16: the arithmetic is not
        def low(s):
            return ea3d.energies(lat["j"], ea3d.lattice(s, lat["L"]),
                                 torch.bfloat16)

    def claimed(reported, s):
        return low(s.to(dev)).double().cpu() if bf16 else reported

    sigma = ref.random_sigma()
    rows = torch.stack([x["best_row"] for x in records])
    e_rows = exact(rows)
    gaps = J.rel_gap(claimed(torch.tensor([x["best_energy"] for x in records],
                                          dtype=torch.float64), rows),
                     e_rows, sigma)
    quality = J.above(e_rows, inst["ground_energy"])
    not_min = torch.tensor([abs(x["best_energy"] - float(x["replica_best"].min()))
                            for x in records], dtype=torch.float64)
    unmoved = torch.zeros(len(records), dtype=torch.float64)
    over = torch.zeros(len(records), dtype=torch.float64)
    r_total = cfg.n_replicas * cfg.n_chains
    for k, x in enumerate(records):
        if "spins" not in x:
            continue
        if x["spins"].shape[0] != r_total:
            raise RuntimeError("the captured state holds another replica count")
        e_best = exact(x["best_spins"])
        gaps[k] = max(gaps[k],
                      J.rel_gap(claimed(x["replica_best"], x["best_spins"]),
                                e_best, sigma).max(),
                      J.rel_gap(claimed(x["energy"].cpu(), x["spins"]),
                                exact(x["spins"]), sigma).max())
        unmoved[k] = float((e_best > -J.UNMOVED_SIGMAS * sigma).sum())
        if lat is not None and x["overlap"] is not None:
            q = ea3d.overlaps(ea3d.lattice(x["spins"].to(dev), lat["L"]),
                              x["slot"], cfg.n_chains)
            over[k] = float((torch.as_tensor(x["overlap"], dtype=torch.float64)
                             - q).abs().max())
    bad = ((gaps > lim["energy_gap"]) | (not_min > lim["best_not_min"])
           | (quality > lim["quality_gap"]) | (unmoved > lim["unmoved"]))
    checks = {"energy_gap": J.check(gaps.max(), lim["energy_gap"]),
              "best_not_min": J.check(not_min.max(), lim["best_not_min"]),
              "quality_gap": J.check(quality.max(), lim["quality_gap"]),
              "unmoved": J.check(unmoved.max(), lim["unmoved"])}
    if lat is not None and "overlap_gap" in lim:
        bad |= over > lim["overlap_gap"]
        checks["overlap_gap"] = J.check(over.max(), lim["overlap_gap"])
    if lat is not None and "thermal_gap" in lim:
        z = _thermal_gap(records, ctx, lat, r.n)
        checks["thermal_gap"] = J.check(z, lim["thermal_gap"])
    return checks, int(bad.sum())


def _thermal_gap(records: list, ctx, lat: dict, n: int) -> float:
    """The largest distance, over the ladder's slots at or above the check's
    ``thermal_min_temp``, between the window's mean energy per spin there
    (each job's second half) and the reference chains' mean at that
    temperature, in units of the reference's energy step between adjacent
    slots there: a ladder read one slot off reads about 1."""
    from portbench.reference import ea3d

    chk, p = ctx.workload["check"], ctx.params
    temps = ea3d.ladder(p)
    hot = np.nonzero(temps >= chk["thermal_min_temp"] - 1e-9)[0]
    mean_p = np.mean([x["slot_energy"][hot] for x in records], axis=0) / n
    mean_r = ea3d.equilibrium_energy(
        lat["j"], temps[hot], chk["chains"], chk["burn"], chk["measure"],
        p["update_rule"], ctx.job_seed(0, "thermal"))
    step = np.abs(np.gradient(mean_r))
    return float(np.max(np.abs(mean_p - mean_r) / step))
