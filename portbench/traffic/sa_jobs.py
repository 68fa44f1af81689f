"""Simulated-annealing jobs: ``spinglass_tpu_torch.anneal.sa.anneal`` called
back to back, each job on a fresh seed, each doing its whole sweep budget
(no early stop).

Parameters (the workload file's ``params``): ``n_replicas``, ``n_sweeps``,
and optionally ``j_dtype`` (a control sets "bfloat16"). Every other
``SAConfig`` field keeps its default.

A job's answer is what ``anneal`` returns: the best energy and the best
replica's spins, and every replica's best energy. For the jobs that the
seed samples (and the last job) the benchmark also copies every replica's
best spins out of the captured state that ``anneal`` keeps
(``graphs.SA_CACHE``), so that each reported per-replica energy is judged
against its spins.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from portbench import program
from portbench.reference import energy, judge as J

SAMPLE_EVERY = 8   # a job is sampled with probability 1 / SAMPLE_EVERY


def _config(p: dict):
    from spinglass_tpu_torch.anneal import sa

    return sa.SAConfig(n_sweeps=p["n_sweeps"], n_replicas=p["n_replicas"],
                       enable_early_stop=False,
                       j_dtype=p.get("j_dtype", "float32"))


def prepare(ctx):
    """The program's problem and configuration, and one job on a seed of
    its own: the first call builds the kernels and captures the chunk, so
    that no job of the window does."""
    r = SimpleNamespace(ctx=ctx, n=ctx.instance["n"],
                        problem=program.problem(ctx.instance, ctx.device),
                        config=_config(ctx.params), last=None)
    _anneal(r, ctx.job_seed(0, "warm-up"))
    return r


def _anneal(r, seed: int):
    from spinglass_tpu_torch.anneal import sa

    return sa.anneal(r.problem, r.config,
                     generator=torch.Generator().manual_seed(seed))


def _all_best_spins(r) -> torch.Tensor:
    """[R, n] int8 best spins of every replica of the last call, read from
    the captured chunk's state."""
    from spinglass_tpu_torch.anneal import graphs

    engine, steps = graphs.SA_CACHE.get(
        r.problem, ("anneal", graphs.config_key(r.config)))
    state = next(iter(steps.values())).state
    return engine.from_layout(state.best_spins)[:, : r.n].to(torch.int8)


def job(r, i: int) -> dict:
    ctx = r.ctx
    t0 = time.perf_counter()
    res = _anneal(r, ctx.job_seed(i))
    seconds = time.perf_counter() - t0
    rec = {"seconds": seconds, "sweeps": res.n_sweeps,
           "flips": res.n_sweeps * r.config.n_replicas * r.n,
           "best_energy": res.best_energy,
           "best_row": torch.as_tensor(res.best_spins[: r.n]).to(torch.int8),
           "replica_best": torch.as_tensor(res.replica_best_energy),
           "spins": _all_best_spins(r)}
    if r.last is not None and not r.last["sampled"]:
        del r.last["spins"]
    rec["sampled"] = i == 0 or ctx.job_seed(i, "sample") % SAMPLE_EVERY == 0
    r.last = rec
    return rec


def end_to_end(records: list, window_s: float) -> dict:
    return {"flips_per_s": sum(x["flips"] for x in records) / window_s}


def counts(records: list) -> dict:
    return {"jobs": len(records), "sweeps": sum(x["sweeps"] for x in records)}


def judge(r, records: list, ctx):
    """(checks, failed answers). Frees the program's captured state first.
    Control "reference_bf16": the energies are those that the reference
    computes on bfloat16 couplings, in the program's place."""
    cfg_r = r.config.n_replicas
    del r.problem
    program.free_captured()
    inst, lim = ctx.instance, ctx.workload["limits"]
    dev = ctx.device
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
    not_min = torch.tensor([abs(x["best_energy"] - float(x["replica_best"].min()))
                            for x in records], dtype=torch.float64)
    quality = torch.full((len(records),), float("-inf"), dtype=torch.float64)
    for k, x in enumerate(records):
        if "spins" not in x:
            continue
        s = x["spins"].to(dev)
        e_all = ref.energies(s).cpu()
        rep = low.energies(s).cpu() if bf16 else x["replica_best"]
        if rep.shape[0] != cfg_r or e_all.shape[0] != cfg_r:
            raise RuntimeError("the captured state holds another replica count")
        gaps[k] = max(gaps[k], J.rel_gap(rep, e_all, sigma).max())
        quality[k] = J.above(e_all, inst["ground_energy"]).max()
    bad = ((gaps > lim["energy_gap"]) | (not_min > lim["best_not_min"])
           | (quality > lim["quality_gap"]))
    checks = {"energy_gap": J.check(gaps.max(), lim["energy_gap"]),
              "best_not_min": J.check(not_min.max(), lim["best_not_min"]),
              "quality_gap": J.check(quality.max(), lim["quality_gap"])}
    return checks, int(bad.sum())
