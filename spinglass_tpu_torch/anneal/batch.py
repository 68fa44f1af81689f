"""Batch annealing over many problem instances.

The counterpart of ``spinglass_tpu.anneal.batch``. The JAX package stacks
same-size problems on a leading problem axis and anneals them as one jitted
``vmap`` of the blocked sweep; here the stack goes through K1 with a problem
axis (``kernels.metropolis_cuda.StackedFusedSweep``): one launch per sweep
for all P problems, problem p on the kernel grid's y axis, so a batch of 16
problems at 16 replicas fills 128 of the H100's SMs where one problem takes
8. Differently sized problems bucket by padded size, as in JAX.

On the card a batch is one replay of a captured run (``_StackedRun``, a
``graphs.CapturedStep``): the start spins, the energy, ``n_sweeps`` stacked
K1 launches with the energy and best tracking after each, and the argmin
per problem, then one read of the results. A captured run is kept per
(P, Np, config, bf16 planes of J, device) with static [P, Np, Np] / [P, Np]
problem buffers, into which each batch's J, h and mask are copied, so a
processor whose batches change size (``AdaptiveBatchProcessor``) captures
once per distinct P and not once per batch. (The JAX function wraps a new
closure in ``jax.jit`` on every call and so compiles every batch.) On the
CPU the same step runs eagerly through the stacked sweep's plain twin.

Randomness: each batch draws from the processor's host generator (seeded
by ``process``'s ``seed``): one device generator for the start spins, then
one Philox seed per problem per sweep (``core.rng.draw_seeds``), so problem
p's sweeps are K1's decisions under its own seeds. ``anneal_stacked`` also
takes given start spins and a given uniform tape, the entry the CPU tests
feed with the JAX function's own draws.

Per-batch failure isolation is the JAX package's: a batch whose stacked run
raises falls back to a per-problem ``sa.anneal`` of each of its problems,
and those results carry ``sa/...`` as their algorithm where a stacked
batch's carry ``sa/batched``.
"""

from __future__ import annotations

import json
import os
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from spinglass_tpu_torch.anneal import graphs, schedules
from spinglass_tpu_torch.anneal.result import AnnealResult
from spinglass_tpu_torch.anneal.sa import SAConfig
from spinglass_tpu_torch.core import rng
from spinglass_tpu_torch.core.problem import IsingProblem, random_spins
from spinglass_tpu_torch.kernels.metropolis_cuda import (KERNEL_NAME,
                                                         StackedFusedSweep,
                                                         planes_needed)


@dataclass(frozen=True)
class BatchConfig:
    """The JAX ``BatchConfig``."""

    max_batch_size: int = 16
    memory_fraction: float = 0.6       # of free device memory
    checkpoint_interval: int = 0       # batches; 0 = off
    checkpoint_dir: Optional[str] = None


@dataclass
class StackedProblem:
    """Same-padded-size problems on a leading problem axis: J [P, Np, Np],
    h and active_mask [P, Np] (the JAX function's stacked ``IsingProblem``)."""

    j: torch.Tensor
    h: torch.Tensor
    active_mask: torch.Tensor
    n_spins: int

    @property
    def n_problems(self) -> int:
        return self.j.shape[0]

    @property
    def n_padded(self) -> int:
        return self.j.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.j.device


def stack_problems(problems: Sequence[IsingProblem]) -> StackedProblem:
    """Stack same-padded-size problems into [P, Np, Np] / [P, Np] tensors on
    their device. Raises on unequal padded sizes, as the JAX function does."""
    n_pad = problems[0].n_padded
    if any(p.n_padded != n_pad for p in problems):
        raise ValueError("stack_problems requires equal padded sizes")
    return StackedProblem(
        j=torch.stack([p.j for p in problems]),
        h=torch.stack([p.h for p in problems]),
        active_mask=torch.stack([p.active_mask for p in problems]),
        n_spins=max(p.n_spins for p in problems),
    )


CPU_FREE_BYTES = 16e9   # the JAX function's figure where a device reports none


def estimate_batch_size(n_padded: int, n_replicas: int, cfg: BatchConfig,
                        device=None) -> int:
    """Memory-based batch sizing, the JAX function's formula: free bytes of
    ``device`` (``torch.cuda.mem_get_info`` on a card; ``CPU_FREE_BYTES`` on
    the CPU, as JAX's CPU device reports no limit) times
    ``memory_fraction`` over 4 (Np^2 + 3 R Np) bytes per problem, at most
    ``max_batch_size``."""
    device = torch.device(device if device is not None else "cpu")
    free = (torch.cuda.mem_get_info(device)[0] if device.type == "cuda"
            else CPU_FREE_BYTES)
    per_problem = 4.0 * (n_padded * n_padded          # J
                         + 3 * n_replicas * n_padded)  # spins/best/uniforms
    est = int(max(1, cfg.memory_fraction * free / max(per_problem, 1)))
    return min(est, cfg.max_batch_size)


def stacked_energy(j: torch.Tensor, h: torch.Tensor,
                   spins: torch.Tensor) -> torch.Tensor:
    """Energies [P, R] of spins [P, Np, R] (K1's layout per problem): the
    JAX ``energy`` per problem, as a batched product."""
    js = torch.bmm(j, spins)
    quad = torch.sum(spins * js, dim=1)
    lin = torch.sum(spins * h[:, :, None], dim=1)
    return -0.5 * quad - lin


def _anneal_steps(sweep: StackedFusedSweep, sa_cfg: SAConfig,
                  spins: torch.Tensor, generator=None, uniforms=None):
    """The stacked anneal from start spins [P, Np, R] (updated in place by
    the kernel): the energy, then per sweep the schedule's temperature, one
    stacked sweep, E += dE and the best per replica; then the argmin per
    problem. Uniforms are Philox under per-problem seeds drawn from
    ``generator``, or the given tape [S, P, R, Np]. Returns (best_energy
    [P], best_spins [P, Np], replica_best [P, R])."""
    p, n_pad, r = spins.shape
    e = stacked_energy(sweep.j, sweep.h, spins)
    best_e, best_s = e, spins.clone()
    for t in range(sa_cfg.n_sweeps):
        temp = schedules.temperature_at(sa_cfg.schedule, t,
                                        device=spins.device)
        beta = 1.0 / torch.clamp(temp, min=1e-10)
        if uniforms is None:
            spins, de, _ = sweep(spins, beta, rng.draw_seeds(generator, p))
        else:
            spins, de, _ = sweep.sweep_with_uniforms(
                spins, beta, uniforms[t].transpose(1, 2).contiguous())
        e = e + de
        improved = e < best_e
        best_e = torch.where(improved, e, best_e)
        best_s = torch.where(improved[:, None, :], spins, best_s)
    b = torch.argmin(best_e, dim=1)
    best_energy = best_e.gather(1, b[:, None])[:, 0]
    best_spins = best_s.gather(2, b[:, None, None].expand(p, n_pad, 1))[:, :, 0]
    return best_energy, best_spins, best_e


def _start_spins(generator: torch.Generator, mask: torch.Tensor,
                 r: int) -> torch.Tensor:
    """Random start spins [P, Np, R] (masked rows +1), drawn on the mask's
    device from a generator seeded by one draw of ``generator``."""
    p, n_pad = mask.shape
    gen = rng.device_generator(generator, mask.device)
    s = random_spins(gen, (p, r, n_pad), mask[:, None, :])
    return s.transpose(1, 2).contiguous()


class _StackedRun:
    """The stacked anneal of one (P, Np, config, planes) on a device, as a
    captured step: static problem buffers (each batch's J, h and mask are
    copied in), the start spins as the step's state (loaded before each
    replay), the results as its outputs. ``sweep.launches`` counts K1's
    launches through it (a replay adds ``n_sweeps``)."""

    def __init__(self, n_problems: int, n_pad: int, sa_cfg: SAConfig,
                 planes: int, device):
        self.sa_cfg = sa_cfg
        self.j = torch.zeros(n_problems, n_pad, n_pad, device=device)
        self.h = torch.zeros(n_problems, n_pad, device=device)
        self.mask = torch.ones(n_problems, n_pad, device=device)
        self.sweep = StackedFusedSweep(self.j, self.h, self.mask,
                                       block_size=sa_cfg.block_size,
                                       rule=sa_cfg.update_rule, planes=planes)
        self.generator = torch.Generator()
        spins = torch.ones(n_problems, n_pad, sa_cfg.n_replicas,
                           device=device)

        def step(state):
            return state, _anneal_steps(self.sweep, sa_cfg, state["spins"],
                                        self.generator)

        self.step = graphs.CapturedStep(
            step, {"spins": spins}, self.generator,
            [(KERNEL_NAME, self.sweep, "launches")])
        self._read = graphs.HostRead()

    @property
    def capture_seconds(self) -> float:
        return self.step.capture_seconds

    def run(self, stacked: StackedProblem, generator: torch.Generator):
        """One batch: its problem copied into the static buffers, its start
        spins drawn, one replay, one read. Returns numpy (best_energy [P],
        best_spins [P, Np], replica_best [P, R])."""
        with torch.no_grad():
            self.j.copy_(stacked.j)
            self.h.copy_(stacked.h)
            self.mask.copy_(stacked.active_mask)
        spins = _start_spins(generator, self.mask, self.sa_cfg.n_replicas)
        self.step.load({"spins": spins})
        out = self.step.replay(generator)
        return [t.numpy() for t in self._read(list(out))]


_RUNS: "OrderedDict" = OrderedDict()   # (P, Np, config, planes, device) -> run
MAX_RUNS = 8


def stacked_run(stacked: StackedProblem, sa_cfg: SAConfig) -> _StackedRun:
    """The captured run for this stack's shape and configuration (built and
    captured on first use; the least recently used of ``MAX_RUNS`` goes)."""
    planes = planes_needed(stacked.j)
    key = (stacked.n_problems, stacked.n_padded, graphs.config_key(sa_cfg),
           planes, str(stacked.device))
    run = _RUNS.get(key)
    if run is None:
        run = _StackedRun(stacked.n_problems, stacked.n_padded, sa_cfg,
                          planes, stacked.device)
        _RUNS[key] = run
        while len(_RUNS) > MAX_RUNS:
            _RUNS.popitem(last=False)
    else:
        _RUNS.move_to_end(key)
    return run


def clear_runs() -> None:
    """Drop the captured stacked runs."""
    _RUNS.clear()


def anneal_stacked(stacked: StackedProblem, sa_cfg: SAConfig,
                   generator: Optional[torch.Generator] = None,
                   init_spins: Optional[torch.Tensor] = None,
                   uniforms: Optional[torch.Tensor] = None) -> dict:
    """The stacked anneal of ``stacked`` (the JAX ``_anneal_stacked``).

    Returns a dict of tensors: ``best_energy`` [P], ``best_spins`` [P, Np]
    and ``replica_best`` [P, R]. With ``init_spins`` [P, R, Np] and
    ``uniforms`` [S, P, R, Np] (both or neither) the run is the eager loop
    on those draws: the CPU tests' entry. Otherwise the start spins and the
    kernel seeds are drawn from ``generator`` and the run is one replay of
    the captured run (``stacked_run``)."""
    if (init_spins is None) != (uniforms is None):
        raise ValueError("give init_spins and uniforms together")
    if init_spins is None:
        generator = generator or torch.Generator().manual_seed(sa_cfg.seed)
        run = stacked_run(stacked, sa_cfg)
        out = run.run(stacked, generator)
        return dict(zip(("best_energy", "best_spins", "replica_best"),
                        (torch.from_numpy(x) for x in out)))
    sweep = StackedFusedSweep(stacked.j, stacked.h, stacked.active_mask,
                              block_size=sa_cfg.block_size,
                              rule=sa_cfg.update_rule)
    spins = init_spins.to(stacked.device, torch.float32).transpose(1, 2)
    best_e, best_s, rep = _anneal_steps(
        sweep, sa_cfg, spins.contiguous(),
        uniforms=uniforms.to(stacked.device, torch.float32))
    return {"best_energy": best_e, "best_spins": best_s, "replica_best": rep}


def eager_stacked(stacked: StackedProblem, sa_cfg: SAConfig,
                  generator: torch.Generator) -> tuple:
    """The eager loop that a captured stacked run replays, on the same
    draws from ``generator`` (start spins, then the kernel seeds): the
    reference a replay must equal bit for bit. Returns (best_energy,
    best_spins, replica_best) tensors and the K1 launches made."""
    sweep = StackedFusedSweep(stacked.j, stacked.h, stacked.active_mask,
                              block_size=sa_cfg.block_size,
                              rule=sa_cfg.update_rule)
    spins = _start_spins(generator, stacked.active_mask, sa_cfg.n_replicas)
    return _anneal_steps(sweep, sa_cfg, spins, generator), sweep.launches


class BatchProcessor:
    """Solve many instances: bucket by padded size, stack, and anneal each
    batch as one stacked run (see the module docstring)."""

    def __init__(self, sa_config: Optional[SAConfig] = None,
                 batch_config: Optional[BatchConfig] = None):
        self.sa_config = sa_config or SAConfig(n_sweeps=200, n_replicas=16)
        self.batch_config = batch_config or BatchConfig()
        self.n_processed = 0
        self.failures: List[int] = []

    @graphs.serialized
    def process(self, problems: Sequence[IsingProblem],
                seed: int = 0) -> List[AnnealResult]:
        """Batched solve preserving input order."""
        results: List[Optional[AnnealResult]] = [None] * len(problems)
        buckets: dict = {}
        for i, p in enumerate(problems):
            buckets.setdefault(p.n_padded, []).append(i)
        generator = torch.Generator().manual_seed(seed)
        cfg = self.sa_config
        batch_no = 0
        for n_pad, idxs in sorted(buckets.items()):
            bs = estimate_batch_size(n_pad, cfg.n_replicas, self.batch_config,
                                     problems[idxs[0]].device)
            for lo in range(0, len(idxs), bs):
                chunk = idxs[lo: lo + bs]
                t0 = time.perf_counter()
                try:
                    out = anneal_stacked(
                        stack_problems([problems[i] for i in chunk]), cfg,
                        generator)
                    best_e, best_s, rep = (out[k].numpy() for k in (
                        "best_energy", "best_spins", "replica_best"))
                    dt = time.perf_counter() - t0
                    for k, i in enumerate(chunk):
                        p = problems[i]
                        flips = cfg.n_sweeps * cfg.n_replicas * p.n_spins
                        results[i] = AnnealResult(
                            best_spins=best_s[k][: p.n_spins],
                            best_energy=float(best_e[k]),
                            replica_best_energy=rep[k],
                            energy_history=np.asarray([float(best_e[k])]),
                            mean_energy_history=np.zeros(1),
                            temperature_history=np.zeros(1),
                            acceptance_history=np.zeros(1),
                            n_sweeps=cfg.n_sweeps,
                            n_replicas=cfg.n_replicas,
                            total_time=dt / len(chunk),
                            sweeps_per_second=cfg.n_sweeps * len(chunk) / dt,
                            spin_flips_per_second=flips * len(chunk) / dt,
                            algorithm="sa/batched",
                            device=p.device.type,
                            seed=seed,
                        )
                        self.n_processed += 1
                except Exception:
                    # per-batch failure isolation, as in the JAX package:
                    # per-problem solves (their results say "sa/...")
                    from spinglass_tpu_torch.anneal.sa import anneal

                    for i in chunk:
                        try:
                            results[i] = anneal(problems[i], cfg)
                            self.n_processed += 1
                        except Exception:
                            self.failures.append(i)
                            results[i] = None
                batch_no += 1
                self._maybe_checkpoint(batch_no, results)
        return results  # type: ignore[return-value]

    def process_stream(self, problem_iter: Iterable[IsingProblem],
                       batch_size: Optional[int] = None, seed: int = 0):
        """Streaming mode: yield results batch by batch without holding the
        whole dataset."""
        batch: List[IsingProblem] = []
        bs = batch_size or self.batch_config.max_batch_size
        for p in problem_iter:
            batch.append(p)
            if len(batch) >= bs:
                yield from self.process(batch, seed=seed)
                batch = []
                seed += 1
        if batch:
            yield from self.process(batch, seed=seed)

    def _maybe_checkpoint(self, batch_no: int, results) -> None:
        cfg = self.batch_config
        if not cfg.checkpoint_interval or not cfg.checkpoint_dir:
            return
        if batch_no % cfg.checkpoint_interval:
            return
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        done = [i for i, r in enumerate(results) if r is not None]
        with open(os.path.join(cfg.checkpoint_dir,
                               f"batch_progress_{batch_no}.json"), "w") as f:
            json.dump({"batch": batch_no, "completed": done,
                       "n_failures": len(self.failures)}, f)


class AdaptiveBatchProcessor(BatchProcessor):
    """Throughput-adaptive batch sizing: grows the batch while throughput
    improves, shrinks on regression (the JAX rule). ``batch_sizes`` lists
    the sizes it ran."""

    def __init__(self, *args, growth: float = 1.5, **kwargs):
        super().__init__(*args, **kwargs)
        self.growth = growth
        self._current_bs = 2
        self._last_throughput = 0.0
        self.batch_sizes: List[int] = []

    @graphs.serialized
    def process(self, problems: Sequence[IsingProblem],
                seed: int = 0) -> List[AnnealResult]:
        results: List[Optional[AnnealResult]] = [None] * len(problems)
        i = 0
        key_seed = seed
        while i < len(problems):
            chunk = list(range(i, min(i + self._current_bs, len(problems))))
            self.batch_sizes.append(len(chunk))
            t0 = time.perf_counter()
            sub = super().process([problems[c] for c in chunk],
                                  seed=key_seed)
            dt = max(time.perf_counter() - t0, 1e-9)
            for k, c in enumerate(chunk):
                results[c] = sub[k]
            throughput = len(chunk) / dt
            if throughput >= self._last_throughput:
                self._current_bs = min(
                    int(self._current_bs * self.growth) + 1,
                    self.batch_config.max_batch_size)
            else:
                self._current_bs = max(2, self._current_bs // 2)
            self._last_throughput = throughput
            i += len(chunk)
            key_seed += 1
        return results  # type: ignore[return-value]
