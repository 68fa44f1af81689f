"""Plotting helpers (matplotlib-gated, headless-safe).

Rebuilds the reference's plot surfaces: AnnealResult 4-panel trajectory
(annealing/result.py:93-145), PT exchange matrix + replica trajectories
(parallel_tempering.py:323-410), schedule comparison
(temperature_scheduler.py:339-421), and the scheduling Gantt chart
(problems/scheduling.py:444-499). All functions save to a path and return it
(no interactive windows).

Copied from ``spinglass_tpu.utils.plotting``; the schedules are the port's
(``anneal/schedules.py``), and matplotlib is imported only when a plot is
drawn."""

from __future__ import annotations

from typing import Optional, Sequence


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError as e:
        raise ImportError(
            "matplotlib is required for plotting; install it or use the "
            "raw histories on the result object") from e


def plot_result(result, path: str = "anneal_result.png") -> str:
    """4-panel trajectory (best energy, mean energy, temperature,
    acceptance)."""
    plt = _plt()
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    x = range(len(result.energy_history))
    axes[0, 0].plot(x, result.energy_history)
    axes[0, 0].set_title("best energy")
    axes[0, 1].plot(x, result.mean_energy_history, color="tab:orange")
    axes[0, 1].set_title("mean energy")
    axes[1, 0].plot(x, result.temperature_history, color="tab:red")
    axes[1, 0].set_yscale("log")
    axes[1, 0].set_title("temperature")
    axes[1, 1].plot(x, result.acceptance_history, color="tab:green")
    axes[1, 1].set_title("acceptance rate")
    for ax in axes.ravel():
        ax.set_xlabel("record step")
        ax.grid(alpha=0.3)
    fig.suptitle(f"{result.algorithm}: best={result.best_energy:.3f}")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_exchange_rates(result, path: str = "pt_exchange.png") -> str:
    """Per-ladder-pair exchange rates (reference parallel_tempering.py
    :323-410)."""
    plt = _plt()
    rates = result.metadata.get("exchange_rates", [])
    ladder = result.metadata.get("ladder", list(range(len(rates) + 1)))
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.bar(range(len(rates)), rates)
    ax.axhline(0.23, color="red", ls="--", label="target ~0.23")
    ax.set_xlabel("ladder pair (cold → hot)")
    ax.set_ylabel("exchange rate")
    ax.set_title(f"PT exchange rates ({len(ladder)} rungs)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_schedules(configs: Sequence, n_sweeps: int = 500,
                   path: str = "schedules.png") -> str:
    """Compare temperature trajectories (reference
    temperature_scheduler.py:339-421)."""
    import numpy as np

    from spinglass_tpu_torch.anneal import schedules as S

    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    for cfg in configs:
        traj = np.asarray(S.schedule_trajectory(cfg, n_sweeps))
        ax.plot(traj, label=cfg.schedule_type.value)
    ax.set_yscale("log")
    ax.set_xlabel("sweep")
    ax.set_ylabel("temperature")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_gantt(solution, path: str = "schedule_gantt.png") -> str:
    """Gantt chart of a SchedulingProblem solution (reference
    scheduling.py:444-499)."""
    plt = _plt()
    assignments = solution.variables["assignments"]
    agents = sorted({v["agent"] for v in assignments.values()})
    fig, ax = plt.subplots(figsize=(10, 0.6 * len(agents) + 2))
    cmap = plt.get_cmap("tab20")
    for t, v in assignments.items():
        y = agents.index(v["agent"])
        ax.barh(y, v["end"] - v["start"], left=v["start"], height=0.6,
                color=cmap(t % 20), edgecolor="black")
        ax.text(v["start"] + (v["end"] - v["start"]) / 2, y, f"T{t}",
                ha="center", va="center", fontsize=8)
    ax.set_yticks(range(len(agents)))
    ax.set_yticklabels([f"agent {a}" for a in agents])
    ax.set_xlabel("time slot")
    ax.set_title(f"makespan = {solution.variables['makespan']}")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_pareto_front(archive, path: str = "pareto.png") -> str:
    """2-objective Pareto front scatter."""
    plt = _plt()
    front = archive.front
    fig, ax = plt.subplots(figsize=(6, 5))
    if front.size:
        order = front[:, 0].argsort()
        ax.plot(front[order, 0], front[order, 1], "o-")
    ax.set_xlabel("objective 1")
    ax.set_ylabel("objective 2")
    ax.set_title(f"Pareto front ({len(archive.objectives)} points)")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_replica_trajectories(result, path: str = "pt_trajectories.png",
                              max_replicas: int = 16) -> str:
    """Per-replica ladder-slot trajectories + exchange-rate bars + ladder —
    the reference's plot_replica_trajectories
    (parallel_tempering.py:323-410), driven by the ``slot_trajectory``
    record in AnnealResult.metadata."""
    import numpy as np

    plt = _plt()
    traj = np.asarray(result.metadata["slot_trajectory"])   # [T, R]
    ladder = np.asarray(result.metadata.get("ladder", []))
    rates = np.asarray(result.metadata.get("exchange_rates", []))
    fig, axes = plt.subplots(2, 2, figsize=(12, 8))

    ax = axes[0][0]
    for r in range(min(traj.shape[1], max_replicas)):
        ax.plot(traj[:, r], alpha=0.7, lw=0.8)
    ax.set_xlabel("super-step")
    ax.set_ylabel("ladder slot (0 = coldest)")
    ax.set_title("Replica slot trajectories")

    ax = axes[0][1]
    if ladder.size:
        ax.plot(ladder, "o-")
        ax.set_yscale("log")
    ax.set_xlabel("slot")
    ax.set_ylabel("temperature")
    ax.set_title("Temperature ladder")

    ax = axes[1][0]
    if rates.size:
        ax.bar(range(len(rates)), rates)
    ax.set_xlabel("adjacent pair")
    ax.set_ylabel("exchange rate")
    ax.set_title("Exchange acceptance rates")

    ax = axes[1][1]
    # slot-occupancy mixing matrix: fraction of time replica r spent in slot s
    n_slots = int(traj.max()) + 1 if traj.size else 1
    occ = np.zeros((traj.shape[1], n_slots))
    for s in range(n_slots):
        occ[:, s] = (traj == s).mean(axis=0)
    im = ax.imshow(occ[:max_replicas], aspect="auto", cmap="viridis")
    fig.colorbar(im, ax=ax, label="occupancy")
    ax.set_xlabel("slot")
    ax.set_ylabel("replica")
    ax.set_title("Slot occupancy (mixing)")

    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_exchange_matrix(result, path: str = "pt_exchange_matrix.png") -> str:
    """Pairwise exchange-flow matrix from the slot trajectory: counts of
    observed slot transitions s -> s' per super-step (the reference's
    exchange-matrix panel, parallel_tempering.py:323-410)."""
    import numpy as np

    plt = _plt()
    traj = np.asarray(result.metadata["slot_trajectory"])   # [T, R]
    n_slots = int(traj.max()) + 1 if traj.size else 1
    mat = np.zeros((n_slots, n_slots))
    for t in range(1, traj.shape[0]):
        np.add.at(mat, (traj[t - 1], traj[t]), 1)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(mat, cmap="magma")
    fig.colorbar(im, ax=ax, label="transitions")
    ax.set_xlabel("slot at t+1")
    ax.set_ylabel("slot at t")
    ax.set_title("Exchange transition matrix")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
