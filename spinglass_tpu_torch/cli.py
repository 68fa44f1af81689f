"""Command-line interface of the port: ``sgt-torch`` (see pyproject.toml).

The counterpart of ``spinglass_tpu.cli`` for the commands that pose and
solve problems: ``solve``, ``ising`` and ``load``. The group takes
``--device cuda|cpu`` (default: the card, see
``core.problem.resolve_device``) where the JAX group takes ``--platform``.

Not ported yet: the JAX group also serves /metrics when SGT_METRICS_PORT is
set (``maybe_start_server_from_env``), which waits for
``utils/metrics_exporter``; the commands ``benchmark``, ``health``,
``train-rl``, ``monitor``, ``autoscale``, ``quality-gates``, ``bench`` and
``cache-stats`` and the interactive shell wait for the modules they drive
(ROADMAP.md Queue 1). Options that need a module not ported yet
(``--tune-ladder``, ``--cluster-moves`` > 0, ``--checkpoint-dir`` /
``--resume``, ``--sweep-method sparse_compact``) reach the driver, whose
``NotImplementedError`` names what is missing and ends the command with
exit status 1.
"""

from __future__ import annotations

import json

import click
import numpy as np

from spinglass_tpu_torch import __version__


@click.group()
@click.version_option(version=__version__, prog_name="spinglass-tpu-torch")
@click.option("--device", default=None, type=click.Choice(["cuda", "cpu"]),
              help="where problems are built and annealed (default: the "
                   "card; without one, pass cpu)")
@click.pass_context
def main(ctx, device):
    """spinglass-tpu-torch: the PyTorch/CUDA port's spin-glass annealer."""
    ctx.obj = {"device": device}


def _make_problem(problem: str, size: int, seed: int, device=None):
    """A random instance of a registered problem at ``size``."""
    from spinglass_tpu_torch.problems import PROBLEM_REGISTRY

    if problem not in PROBLEM_REGISTRY:
        raise click.BadParameter(
            f"unknown problem {problem!r}; choose from "
            f"{sorted(PROBLEM_REGISTRY)}")
    if size < 2:
        raise click.BadParameter(f"--size must be >= 2, got {size}")
    template = PROBLEM_REGISTRY[problem](device=device)
    if problem == "tsp":
        template.generate_random_instance(n_cities=size, seed=seed)
    elif problem in ("vrp", "vrp_arc"):
        template.generate_random_instance(n_customers=size, seed=seed)
    elif problem == "maxcut":
        template.generate_random_instance(n_nodes=size, seed=seed)
    elif problem == "qap":
        template.generate_random_instance(n=size, seed=seed)
    elif problem in ("scheduling", "jobshop"):
        template.generate_random_instance(n_tasks=size, n_agents=max(
            2, size // 3), seed=seed)
    elif problem == "resource":
        template.generate_random_instance(n_demands=size, n_resources=max(
            2, size // 3), seed=seed)
    elif problem == "coordination":
        template.generate_random_instance(n_tasks=size, n_agents=max(
            2, size // 2), seed=seed)
    else:
        template.generate_random_instance(n_tasks=size, n_agents=max(
            2, size // 3), seed=seed)
    return template


@main.command()
@click.option("-p", "--problem", default="tsp", help="problem kind")
@click.option("-s", "--size", default=10, help="instance size")
@click.option("-a", "--algorithm", default="sa",
              type=click.Choice(["sa", "pt"]))
@click.option("--sweeps", default=1000)
@click.option("--replicas", default=32)
@click.option("--schedule", default="geometric")
@click.option("--seed", default=42)
@click.option("-o", "--output", default=None, help="save solution JSON")
@click.option("--tune-ladder", is_flag=True,
              help="PT only: feedback-optimize the temperature ladder with a "
                   "pilot run before the main anneal (not ported yet)")
@click.option("--exchange-method", default="nearest_neighbor",
              type=click.Choice(["nearest_neighbor", "all_pairs"]),
              help="PT replica-exchange pairing")
@click.option("--chains", default=1, help="PT: independent chains batched "
                                          "together")
@click.option("--cluster-moves", default=0,
              help="PT: Swendsen-Wang sweeps mixed in per exchange interval "
                   "(not ported yet)")
@click.option("--checkpoint-dir", default=None,
              help="periodic state checkpoints (not ported yet)")
@click.option("--resume", is_flag=True)
@click.option("--sweep-method", default="auto",
              type=click.Choice(["auto", "colored", "blocked", "sparse",
                                 "sparse_t", "sparse_compact"]),
              help="sweep engine override (auto picks by problem shape, "
                   "device, and replica count)")
@click.option("--quiet", is_flag=True)
@click.pass_context
def solve(ctx, problem, size, algorithm, sweeps, replicas, schedule, seed,
          output, tune_ladder, exchange_method, chains, cluster_moves,
          checkpoint_dir, resume, sweep_method, quiet):
    """Solve a randomly generated problem instance."""
    from spinglass_tpu_torch.anneal import pt as pt_mod
    from spinglass_tpu_torch.anneal.sa import SAConfig
    from spinglass_tpu_torch.anneal.schedules import (ScheduleConfig,
                                                      ScheduleType)
    from spinglass_tpu_torch.problems.base import anneal_metadata

    template = _make_problem(problem, size, seed, ctx.obj["device"])
    if algorithm == "sa":
        cfg = SAConfig(n_sweeps=sweeps, n_replicas=replicas,
                       schedule=ScheduleConfig(
                           schedule_type=ScheduleType(schedule),
                           initial_temp=5.0, final_temp=0.01,
                           total_sweeps=sweeps),
                       sweep_method=sweep_method,
                       seed=seed)
        sol = template.solve(cfg, checkpoint_dir=checkpoint_dir,
                             resume=resume)
    else:
        template.encode_to_ising()
        cfg = pt_mod.PTConfig(n_replicas=replicas, n_sweeps=sweeps, seed=seed,
                              exchange_method=exchange_method,
                              sweep_method=sweep_method,
                              n_chains=chains, cluster_moves=cluster_moves)
        ladder = None
        if tune_ladder:
            ladder, _ = pt_mod.tune_ladder(
                template.problem, cfg, n_pilot_sweeps=max(sweeps // 4, 50))
            if not quiet:
                click.echo(f"tuned ladder: {np.round(ladder, 3).tolist()}")
        res = pt_mod.run(template.problem, cfg, ladder_override=ladder,
                         checkpoint_dir=checkpoint_dir, resume=resume)
        sol = template.decode_solution(res.best_spins)
        sol.energy = res.best_energy
        sol.metadata["anneal"] = anneal_metadata(res)
    if not quiet:
        click.echo(f"objective: {sol.objective_value:.4f}")
        click.echo(f"energy:    {sol.energy:.4f}")
        click.echo(f"feasible:  {sol.is_feasible}")
        if sol.constraint_violations:
            click.echo(f"violations: {sol.n_violations}")
    if output:
        with open(output, "w") as f:
            f.write(sol.to_json())
        click.echo(f"saved to {output}")


@main.command()
@click.option("-n", "--n-spins", default=64)
@click.option("--topology", "topo", default="fully_connected",
              type=click.Choice(["fully_connected", "grid", "chain",
                                 "random", "small_world", "scale_free"]))
@click.option("--dist", default="gaussian")
@click.option("--sweeps", default=1000)
@click.option("--replicas", default=32)
@click.option("--seed", default=42)
@click.option("-o", "--output", default=None, help="save result npz")
@click.pass_context
def ising(ctx, n_spins, topo, dist, sweeps, replicas, seed, output):
    """Anneal a raw random Ising instance."""
    from spinglass_tpu_torch.anneal.sa import SAConfig, anneal
    from spinglass_tpu_torch.core import topology as T
    from spinglass_tpu_torch.core.problem import IsingProblem

    generators = {
        "fully_connected": lambda: T.fully_connected(
            n_spins, dist=dist, scale=1.0 / np.sqrt(n_spins), seed=seed),
        "grid": lambda: T.grid_2d(int(np.sqrt(n_spins)),
                                  int(np.sqrt(n_spins)), dist=dist, seed=seed),
        "chain": lambda: T.chain(n_spins, dist=dist, seed=seed),
        "random": lambda: T.random_graph(n_spins, dist=dist, seed=seed),
        "small_world": lambda: T.small_world(n_spins, dist=dist, seed=seed),
        "scale_free": lambda: T.scale_free(n_spins, dist=dist, seed=seed),
    }
    problem = IsingProblem.from_dense(generators[topo](),
                                      device=ctx.obj["device"])
    res = anneal(problem, SAConfig(n_sweeps=sweeps, n_replicas=replicas,
                                   seed=seed))
    click.echo(f"best energy: {res.best_energy:.4f}")
    click.echo(f"sweeps/s:    {res.sweeps_per_second:.1f}")
    click.echo(f"flips/s:     {res.spin_flips_per_second:.2e}")
    click.echo(f"algorithm:   {res.algorithm}")
    if output:
        res.save(output)
        click.echo(f"saved to {output}")


@main.command()
@click.argument("path", type=click.Path(exists=True))
def load(path):
    """Inspect a saved AnnealResult npz."""
    from spinglass_tpu_torch.anneal.result import AnnealResult

    res = AnnealResult.load(path)
    click.echo(json.dumps(res.summary(), indent=2))


if __name__ == "__main__":
    main()
