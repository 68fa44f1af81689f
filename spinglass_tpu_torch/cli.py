"""Command-line interface of the port: ``sgt-torch`` (see pyproject.toml).

The counterpart of ``spinglass_tpu.cli``: ``solve``, ``ising`` and ``load``
pose and solve problems, ``train-rl`` runs the RL training pipeline, and the
operations commands ``benchmark`` (the standard suite,
``benchmarks/runner.py``), ``health`` (exit 1 when unhealthy), ``monitor``,
``autoscale``, ``bench`` (one headline benchmark's JSON line) and
``cache-stats`` run the deployment's checks. As in the JAX group, ``main``
serves /metrics from the process when SGT_METRICS_PORT is set
(``utils.metrics_exporter.maybe_start_server_from_env``). The group takes
``--device cuda|cpu`` (default: the card, see
``core.problem.resolve_device``) where the JAX group takes ``--platform``.

Not ported yet: ``quality-gates`` and the interactive shell (ROADMAP.md
Queue 1). Every option of the JAX ``solve`` command runs:
``--tune-ladder`` (``pt.tune_ladder``), ``--cluster-moves`` (Swendsen-Wang
in the PT super-step), ``--checkpoint-dir`` / ``--resume`` (both drivers)
and ``--sweep-method sparse_compact``.
"""

from __future__ import annotations

import json
import sys

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
    # SGT_METRICS_PORT set -> serve /metrics from this process, so that the
    # solver gauges can be scraped (docker-compose's prometheus service)
    from spinglass_tpu_torch.utils.metrics_exporter import (
        maybe_start_server_from_env)

    maybe_start_server_from_env()


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
                   "pilot run before the main anneal")
@click.option("--exchange-method", default="nearest_neighbor",
              type=click.Choice(["nearest_neighbor", "all_pairs"]),
              help="PT replica-exchange pairing")
@click.option("--chains", default=1, help="PT: independent chains batched "
                                          "together")
@click.option("--cluster-moves", default=0,
              help="PT: Swendsen-Wang sweeps mixed in per exchange interval")
@click.option("--checkpoint-dir", default=None,
              help="periodic state checkpoints; with --resume continues a "
                   "killed run exactly")
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


@main.command("train-rl")
@click.option("--agent", default="ppo", type=click.Choice(["ppo", "dqn"]))
@click.option("--updates", default=50)
@click.option("--envs", default=32)
@click.option("--spins", default=64)
@click.option("--checkpoint-dir", default=None)
@click.pass_context
def train_rl(ctx, agent, updates, envs, spins, checkpoint_dir):
    """Train the RL temperature controller on random instances."""
    from spinglass_tpu_torch.rl.env import EnvConfig
    from spinglass_tpu_torch.rl.train import (RLTrainingPipeline,
                                              TrainingConfig, default_problem)

    pipe = RLTrainingPipeline(
        TrainingConfig(agent=agent, n_updates=updates,
                       checkpoint_dir=checkpoint_dir),
        env_cfg=EnvConfig(n_envs=envs),
        problem=default_problem(spins, device=ctx.obj["device"]))
    out = pipe.train(verbose=True)
    click.echo(f"env-steps/s: {out['env_steps_per_second']:.1f}")


@main.command()
@click.option("--sizes", default="20,50")
@click.option("--sweeps", default=500)
@click.option("--trials", default=2)
@click.option("-o", "--output", default="benchmark_results.json")
@click.pass_context
def benchmark(ctx, sizes, sweeps, trials, output):
    """Run the standard benchmark suite."""
    from spinglass_tpu_torch.benchmarks.runner import (BenchmarkRunner,
                                                       standard_suite)

    sizes_t = tuple(int(s) for s in sizes.split(","))
    runner = BenchmarkRunner(n_sweeps=sweeps, n_trials=trials,
                             device=ctx.obj["device"])
    runner.run_suite(standard_suite(sizes_t, device=ctx.obj["device"]))
    runner.save(output)
    for k, v in runner.summary().items():
        click.echo(f"{k}: best={v['best_objective']:.3f} "
                   f"time={v['mean_time']:.2f}s "
                   f"flips/s={v['mean_flips_per_sec']:.2e}")
    click.echo(f"full results → {output}")


@main.command()
@click.pass_context
def health(ctx):
    """Run the framework health checks (the device probe and the
    micro-anneal on --device; exit 1 when unhealthy)."""
    from spinglass_tpu_torch.utils.health import HealthMonitor, device_checks

    report = HealthMonitor(device_checks(ctx.obj["device"])).run()
    click.echo(json.dumps(report, indent=2))
    sys.exit(0 if report["status"] != "unhealthy" else 1)


@main.command()
@click.option("--watch", default=0, type=int,
              help="sample every N seconds (0 = one snapshot)")
@click.option("--serve-port", default=0, type=int,
              help="also serve /metrics for Prometheus on this port")
@click.option("--serve-host", default="127.0.0.1",
              help="bind address for /metrics (0.0.0.0 inside a container)")
def monitor(watch, serve_port, serve_host):
    """Resource snapshot (host and each card's memory) / Prometheus
    endpoint."""
    import time as _time

    from spinglass_tpu_torch.utils.metrics_exporter import (MetricsServer,
                                                            global_registry)
    from spinglass_tpu_torch.utils.monitoring import (device_memory_stats,
                                                      global_monitor,
                                                      host_stats)

    mon = global_monitor()
    server = None
    if serve_port:
        server = MetricsServer(host=serve_host, port=serve_port).start()
        click.echo(f"serving /metrics on {serve_host}:{server.port}")
    try:
        while True:
            snap = {"host": host_stats(), "device": device_memory_stats()}
            if server:
                global_registry().sync_from_monitor(mon)
            click.echo(json.dumps(snap))
            if not watch:
                break
            _time.sleep(watch)
    except KeyboardInterrupt:
        pass
    finally:
        if server:
            server.stop()


@main.command()
@click.option("--replicas", default=256, help="current replica count")
@click.option("--utilization", default=0.9, type=float)
@click.option("--hbm-used", default=0.5, type=float,
              help="fraction of the device memory in use")
@click.option("--queue", default=4, type=int)
def autoscale(replicas, utilization, hbm_used, queue):
    """One auto-scaling decision from observed utilization."""
    from spinglass_tpu_torch.utils.autoscale import AdaptiveScaler

    d = AdaptiveScaler(cooldown_s=0.0).decide(
        n_replicas=replicas, utilization=utilization,
        hbm_used_fraction=hbm_used, queue_depth=queue)
    click.echo(json.dumps({
        "resource": d.resource, "current": d.current, "target": d.target,
        "reason": d.reason}))


@main.command("bench")
@click.option("--path", "bench_path", default="dense",
              type=click.Choice(sorted(("dense", "sparse", "pt10k", "ttt",
                                        "rl"))),
              help="which headline benchmark to run")
def bench_cmd(bench_path):
    """Run a headline benchmark on the card and print its JSON line (the
    bodies of ``benchmarks/headline.py``, at the JAX package's shapes)."""
    from spinglass_tpu_torch.benchmarks import headline

    click.echo(json.dumps(headline.PATHS[bench_path]()))


@main.command("cache-stats")
def cache_stats():
    """Solver-cache statistics: the solution cache and the captured
    drivers' step caches."""
    from spinglass_tpu_torch.anneal import batch, graphs
    from spinglass_tpu_torch.utils.cache import anneal_cache_stats

    click.echo(json.dumps({**anneal_cache_stats(),
                           "sa_steps": len(graphs.SA_CACHE),
                           "pt_steps": len(graphs.PT_CACHE),
                           "batch_runs": len(batch._RUNS)}))


if __name__ == "__main__":
    main()
