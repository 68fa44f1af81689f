"""Simulated quantum annealing jobs:
``spinglass_tpu_torch.research.quantum.simulated_quantum_annealing`` called
back to back, each job on a fresh generator seed, each doing its whole
schedule.

Parameters (the workload file's ``params``): ``n_trotter``, ``beta``,
``gamma_start``, ``gamma_schedule``, ``n_stages``, ``sweeps_per_stage``,
``n_replicas`` and ``carry_state``, the ``SQAConfig`` fields of the same
names. A job's flips are sweeps x n_replicas x n_trotter x N, N the
instance's spins (every Trotter spin is one site of one slice).

A job's answer is what the call returns: every replica's least slice energy
(``replica_best_energy``) and the P slice energies it was the least of, the
job's best energy and its spins, and every replica's energy on the Trotter
problem at the last Gamma (``metadata["final_action"]``). After each job the
benchmark takes the final Trotter state of every replica that the call
carried (``metadata["final_state"]``, on the card) and each replica's
slice-to-slice correlation from it there; the state itself,
and every replica's least slice, it keeps only for the jobs that the seed
samples (and the first).

The check (``judge``): ``energy_gap`` (every reported energy against the
float64 energy of its spins: each job's best, and of sampled jobs every
replica's least slice energy and its P slice energies), ``action_gap``
(sampled jobs' ``final_action`` against the reference's float64 action of
their final states at the last Gamma), ``quality_gap`` (each job's best
above the instance's best-known energy, relative to it), ``schedule_gap``
(the window's mean least slice energy per spin and mean slice-to-slice
correlation against the reference's own carried chains over the same
schedule, run on the card after the window: the larger of the two gaps in
units of their combined standard error), ``best_not_min`` and ``unmoved``.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import program
from portbench.reference import ea2d, judge as J

SAMPLE_EVERY = 4   # a job is sampled with probability 1 / SAMPLE_EVERY
FIELDS = ("n_trotter", "beta", "gamma_start", "gamma_schedule", "n_stages",
          "sweeps_per_stage", "n_replicas", "carry_state")


def _config(p: dict):
    from spinglass_tpu_torch.research import quantum

    return quantum.SQAConfig(**{k: p[k] for k in FIELDS})


def prepare(ctx):
    """The program's problem and configuration, and one job on a seed of
    its own: the first call builds the Trotter problem and the kernels and
    captures the stage's chunk, so that no job of the window does."""
    r = SimpleNamespace(ctx=ctx, n=ctx.instance["n"],
                        problem=program.problem(ctx.instance, ctx.device),
                        config=_config(ctx.params), last=None)
    _run(r, ctx.job_seed(0, "warm-up"))
    return r


def _run(r, seed: int):
    from spinglass_tpu_torch.research import quantum

    return quantum.simulated_quantum_annealing(
        r.problem, r.config, generator=torch.Generator().manual_seed(seed))


def job(r, i: int) -> dict:
    ctx, cfg = r.ctx, r.config
    t0 = time.perf_counter()
    res = _run(r, ctx.job_seed(i))
    seconds = time.perf_counter() - t0
    md = res.metadata
    final = md["final_state"][:, : cfg.n_trotter * r.n].to(torch.int8)
    lat = ctx.instance["lattice"]
    corr = ea2d.correlation(ea2d.lattice(final, lat["L"], cfg.n_trotter))
    rec = {"seconds": seconds, "sweeps": res.n_sweeps,
           "flips": res.n_sweeps * cfg.n_replicas * cfg.n_trotter * r.n,
           "best_energy": res.best_energy,
           "best_row": torch.as_tensor(res.best_spins[: r.n]).to(torch.int8),
           "replica_best": torch.as_tensor(res.replica_best_energy,
                                           dtype=torch.float64),
           "slice_energy": torch.as_tensor(np.asarray(md["slice_energies"]),
                                           dtype=torch.float64),
           "action": torch.as_tensor(md["final_action"],
                                     dtype=torch.float64),
           "gamma_last": float(md["gammas"][-1]),
           "corr": corr.cpu()}
    rec["sampled"] = i == 0 or ctx.job_seed(i, "sample") % SAMPLE_EVERY == 0
    if rec["sampled"]:
        rec["state"] = final.cpu()
        rec["replica_spins"] = torch.as_tensor(md["replica_spins"])
    return rec


def end_to_end(records: list, window_s: float) -> dict:
    return {"flips_per_s": sum(x["flips"] for x in records) / window_s}


def counts(records: list) -> dict:
    return {"jobs": len(records), "sweeps": sum(x["sweeps"] for x in records)}


def _z(a: torch.Tensor, b: torch.Tensor) -> float:
    """|mean a - mean b| over their combined standard error."""
    se = torch.sqrt(a.var() / len(a) + b.var() / len(b))
    return float((a.mean() - b.mean()).abs() / se.clamp(min=1e-300))


def judge(r, records: list, ctx):
    """(checks, failed answers). Frees the program's captured state first.
    Control "reference_bf16": the energies and actions are those that the
    reference computes in bfloat16 arithmetic, in the program's place."""
    cfg = r.config
    del r.problem
    program.free_captured()
    inst, lim, dev = ctx.instance, ctx.workload["limits"], ctx.device
    ea2d.exact()
    lat = inst["lattice"]
    j, L, p = lat["j"].to(dev), lat["L"], cfg.n_trotter
    bf16 = ctx.control == "reference_bf16"
    dtype = torch.bfloat16 if bf16 else torch.float64

    def exact(s, d=torch.float64):      # [R, N] or [R, P N] int8 -> energies
        return ea2d.energies(j, ea2d.lattice(s.to(dev), L), d).double().cpu()

    sigma = ea2d.random_sigma(j)
    rows = torch.stack([x["best_row"] for x in records])
    e_rows = exact(rows)
    claimed = (exact(rows, dtype) if bf16 else
               torch.tensor([x["best_energy"] for x in records],
                            dtype=torch.float64))
    gaps = J.rel_gap(claimed, e_rows, sigma)
    quality = J.above(e_rows, inst["ground_energy"])
    not_min = torch.tensor([abs(x["best_energy"]
                                - float(x["replica_best"].min()))
                            for x in records], dtype=torch.float64)
    unmoved = torch.tensor([float((x["replica_best"]
                                   > -J.UNMOVED_SIGMAS * sigma).sum())
                            for x in records], dtype=torch.float64)
    action = torch.zeros(len(records), dtype=torch.float64)
    for k, x in enumerate(records):
        if "state" not in x:
            continue
        state = x["state"].to(dev)
        if state.shape[0] != cfg.n_replicas:
            raise RuntimeError("the captured state holds another replica "
                               "count")
        trot = ea2d.lattice(state, L, p)
        e_all = ea2d.energies(j, trot).cpu()               # [R, P]
        e_least = exact(x["replica_spins"])
        claim_all = exact(state.reshape(-1, L * L), dtype).reshape(
            e_all.shape) if bf16 else x["slice_energy"]
        claim_least = exact(x["replica_spins"], dtype) if bf16 else \
            x["replica_best"]
        gaps[k] = max(gaps[k], J.rel_gap(claim_all, e_all, sigma).max(),
                      J.rel_gap(claim_least, e_least, sigma).max(),
                      J.rel_gap(e_least, e_all.min(dim=1).values,
                                sigma).max())
        unmoved[k] = float((e_all.min(dim=1).values
                            > -J.UNMOVED_SIGMAS * sigma).sum())
        jp = ea2d.j_perp(cfg.beta, x["gamma_last"], p)
        want = ea2d.action(j, trot, jp).cpu()
        claim_act = (ea2d.action(j, trot, jp, dtype).double().cpu() if bf16
                     else x["action"])
        action[k] = J.rel_gap(claim_act, want, sigma).max()
    bad = ((gaps > lim["energy_gap"]) | (action > lim["action_gap"])
           | (not_min > lim["best_not_min"])
           | (quality > lim["quality_gap"]) | (unmoved > lim["unmoved"]))
    chk = ctx.workload["check"]
    least_r, corr_r = ea2d.schedule_chains(
        j, ctx.params, chk["chains"], chk["block"],
        ctx.job_seed(0, "schedule"))
    least_p = torch.cat([x["replica_best"] for x in records])
    corr_p = torch.cat([x["corr"] for x in records])
    schedule = max(_z(least_p / L ** 2, least_r / L ** 2), _z(corr_p, corr_r))
    checks = {"energy_gap": J.check(gaps.max(), lim["energy_gap"]),
              "action_gap": J.check(action.max(), lim["action_gap"]),
              "quality_gap": J.check(quality.max(), lim["quality_gap"]),
              "schedule_gap": J.check(schedule, lim["schedule_gap"]),
              "best_not_min": J.check(not_min.max(), lim["best_not_min"]),
              "unmoved": J.check(unmoved.max(), lim["unmoved"])}
    return checks, int(bad.sum())
