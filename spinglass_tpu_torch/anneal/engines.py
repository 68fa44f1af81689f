"""Sweep engines shared by the SA and PT drivers, and the policy that picks one.

The counterpart of ``spinglass_tpu.anneal.engines``. An engine declares a
spin layout:
  * "rn": spins [R, Np] (replica-major), the plain PyTorch engines;
  * "nr": spins [Np, R] (spin-major), the fused CUDA kernel K1, and
    [NS, R] in a colour-sorted order for the sparse engine of
    ``kernels/sparse.py`` (K2/K3/K4); the kernels update them in place.
The drivers keep annealing state in the engine's layout and convert only at
the edges of a run. An engine's ``kernel_names`` name the kernels its sweeps
can launch (none for the plain PyTorch engines): the keys under which a
driver reports its launches from the ledger of ``kernels.build``.

Engine selection (make_engine), as in the JAX package with "the problem
lies on a CUDA device" where it tests for a TPU:
  1. an ``EllProblem``, sweep_method "sparse"/"sparse_t", or an "auto" dense
     problem of at least SPARSE_MIN_SPINS spins with density below
     SPARSE_DENSITY_THRESHOLD: a sorted sparse engine, the transposed
     SortedSparseTEngine for "sparse_t" or for r_hint >=
     SPARSE_T_MIN_REPLICAS_CUDA on a CUDA device, else the [R, N]
     SortedSparseEngine;
  2. sweep_method="colored", or "auto" with a colouring of at most
     ``max_colors`` colours: colored sweeps (one matmul per colour);
  3. otherwise, on a CUDA device: the fused K1 kernel (CudaFusedEngine);
  4. otherwise: the blocked sweep in plain PyTorch (BlockedEngine).
sweep_method="sparse_compact" takes the compact coloured ``SparseEngine``
(plain PyTorch) on dense and ELL problems alike, as in the JAX package.

Randomness: ``sweep(spins, beta, generator)`` takes the driver's host
``torch.Generator`` and draws one seed from it per sweep
(``core.rng.draw_seed``): the kernels take it as their Philox key,
the plain engines seed a generator on the spins' device with it and draw
their uniforms there. In the eager loop the seed is a host int, passed to
the kernel by value. While a driver's step is captured (``anneal.graphs``)
the same draw goes through the step's random tape (``core.rng``): the
kernel gets a seed slot in device memory, which the tape refills from the
generator before each replay, and the plain engines' uniforms are the
tape's static tensors, drawn anew before each replay. Both ways draw the
same numbers in the same order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spinglass_tpu_torch.core import energy as energy_ops
from spinglass_tpu_torch.core import rng
from spinglass_tpu_torch.core import topology
from spinglass_tpu_torch.core.problem import IsingProblem, real_rows
from spinglass_tpu_torch.kernels import sweeps as sweep_kernels
from spinglass_tpu_torch.kernels.metropolis_cuda import J_DTYPES, FusedSweep
from spinglass_tpu_torch.kernels.track_cuda import BestTrack

SPARSE_DENSITY_THRESHOLD = 0.05
SPARSE_MIN_SPINS = 2048
# the JAX package's replica count from which the transposed sparse engine is
# picked; R % 128 == 0 is also K2's dispatch condition
SPARSE_T_MIN_REPLICAS = 128
# on a CUDA device the transposed engine is picked from this many replicas:
# below 128 it runs K4, one launch per colour at any R, where the plain
# [R, N] engine makes ~280 launches a sweep. PT on the 10k bench graph at 16
# replicas on the H100 (700 W), ms/sweep in turns: plain 2.4-4.5, K4 0.23-0.44
SPARSE_T_MIN_REPLICAS_CUDA = 16


def best_track(engine) -> BestTrack:
    """The SA driver's best tracking of states in ``engine``'s layout
    (``kernels.track_cuda.BestTrack``), made on first use: one per engine,
    so an engine's captured chunks share its copies."""
    if getattr(engine, "best_track", None) is None:
        engine.best_track = BestTrack()
    return engine.best_track


def best_row(engine, spins: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Replica ``r`` (a 0-d index tensor on the spins' device) of spins in
    ``engine``'s layout, as an [Np] float32 row: only that replica is
    converted, and nothing waits for the device."""
    dim = 1 if engine.layout == "nr" else 0
    return engine.from_layout(spins.index_select(dim, r.reshape(1)))[0]


class SweepEngine:
    """Base: sweep(spins, beta, generator) -> (spins, dE[R], n_accepted[R])."""

    layout = "rn"
    name = "base"
    kernel_names: tuple = ()

    def __init__(self, problem: IsingProblem):
        self.problem = problem

    def to_layout(self, spins_rn: torch.Tensor,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """[R, Np] -> this engine's layout, as a new contiguous tensor (in
        ``dtype`` if given)."""
        s = spins_rn.t() if self.layout == "nr" else spins_rn
        s = s.clone(memory_format=torch.contiguous_format)
        return s if dtype is None else s.to(dtype)

    def from_layout(self, spins: torch.Tensor) -> torch.Tensor:
        """This engine's layout -> [R, Np] float32: a view of float32
        spins, a copy of others (the SA best spins are int8 on the card)."""
        return (spins.t() if self.layout == "nr" else spins).to(torch.float32)

    def row_mask(self) -> torch.Tensor:
        """[rows] float32 over the spin axis of this engine's layout: 0 on
        a real spin, -inf on padding."""
        return real_rows(self.problem.active_mask)

    def energy(self, spins: torch.Tensor) -> torch.Tensor:
        """Exact energies [R] in this engine's layout."""
        if self.layout == "nr":
            return energy_ops.energy_t(self.problem, spins)
        return energy_ops.energy(self.problem, spins)

    def _uniforms(self, spins: torch.Tensor, generator: torch.Generator):
        """Uniforms drawn on the spins' device (no host-to-device copy)."""
        return rng.device_uniforms(generator, spins.shape, spins.device)

    def sweep(self, spins, beta, generator):
        raise NotImplementedError


class ColoredEngine(SweepEngine):
    """Same-colour simultaneous updates (exact for proper colourings)."""

    name = "colored"

    def __init__(self, problem: IsingProblem, colors: np.ndarray,
                 rule: str = "metropolis"):
        super().__init__(problem)
        self.rule = rule
        self.n_colors = int(colors.max()) + 1 if colors.size else 1
        self.masks = sweep_kernels.color_masks_from_colors(
            colors, problem.n_padded, device=problem.device)

    def sweep(self, spins, beta, generator):
        return self.sweep_with_uniforms(spins, beta,
                                        self._uniforms(spins, generator))

    def sweep_with_uniforms(self, spins, beta, uniforms):
        """One sweep on the caller's uniforms [R, Np]."""
        return sweep_kernels.colored_sweep(
            self.problem, self.masks, spins, beta, uniforms, rule=self.rule)


class BlockedEngine(SweepEngine):
    """Exact sequential-equivalent blocked sweep in plain PyTorch (the CPU
    path; counterpart of the JAX ``BlockedXLAEngine``)."""

    name = "blocked"

    def __init__(self, problem: IsingProblem, block_size: int = 128,
                 rule: str = "metropolis"):
        super().__init__(problem)
        self.block_size = block_size
        self.rule = rule

    def sweep(self, spins, beta, generator):
        return self.sweep_with_uniforms(spins, beta,
                                        self._uniforms(spins, generator))

    def sweep_with_uniforms(self, spins, beta, uniforms):
        """One sweep on the caller's uniforms [R, Np]."""
        return sweep_kernels.blocked_sweep(
            self.problem, spins, beta, uniforms,
            block_size=self.block_size, rule=self.rule)


class CudaFusedEngine(SweepEngine):
    """The fused dense sweep kernel (K1, or with ``FusedSweep``'s variant
    flags K5-K7), [Np, R] layout updated in place, in-kernel Philox
    uniforms (counterpart of the JAX ``PallasEngine``)."""

    layout = "nr"
    name = "cuda_fused"

    def __init__(self, problem: IsingProblem, block_size: int = 0,
                 rule: str = "metropolis", j_dtype: str = "float32",
                 **variant):
        super().__init__(problem)
        self.fused = FusedSweep(problem, block_size=block_size, rule=rule,
                                j_dtype=j_dtype, **variant)
        self.kernel_names = (self.fused.kernel_name,)

    def sweep(self, spins_t, beta, generator):
        return self.fused(spins_t, beta, rng.draw_seed(generator))

    def sweep_with_uniforms(self, spins_t, beta, uniforms_t):
        """One sweep on the caller's uniforms [Np, R]."""
        return self.fused.sweep_with_uniforms(spins_t, beta, uniforms_t)


class GivenUniforms(SweepEngine):
    """An engine (blocked, coloured, K1, or a sorted sparse engine on its
    threshold path) sweeping on a given tape of uniforms [S, R, Np] in
    place of its generator's draws: sweep t of the run reads row t, spin i
    of replica r consuming uniforms[t, r, i] in the problem's own order
    (the engine's ``to_layout`` puts them in its layout). The entry through
    which the CPU tests feed a driver the JAX package's draws, or a plain
    reference's. Eager only: ``t`` counts the sweeps on the host, so a
    captured step would freeze it."""

    ENGINES = ("blocked", "colored", "cuda_fused", "sparse_sorted",
               "sparse_sorted_t")

    def __init__(self, engine: SweepEngine, uniforms):
        if not hasattr(engine, "sweep_with_uniforms") or \
                engine.name not in self.ENGINES:
            raise ValueError(f"given uniforms need one of the engines "
                             f"{self.ENGINES}, got {engine.name!r}")
        super().__init__(engine.problem)
        self.engine, self.layout, self.name = engine, engine.layout, engine.name
        self.kernel_names = engine.kernel_names
        self.uniforms = torch.as_tensor(np.asarray(uniforms, np.float32),
                                        device=engine.problem.device)
        self.t = 0

    def to_layout(self, spins_rn, dtype=None):
        return self.engine.to_layout(spins_rn, dtype)

    def from_layout(self, spins):
        return self.engine.from_layout(spins)

    def row_mask(self):
        return self.engine.row_mask()

    def energy(self, spins):
        return self.engine.energy(spins)

    def sweep(self, spins, beta, generator):
        u = self.uniforms[self.t]
        self.t += 1
        return self.engine.sweep_with_uniforms(
            spins, beta, self.engine.to_layout(u, torch.float32))


def make_engine(problem, *, sweep_method: str = "auto",
                update_rule: str = "metropolis", block_size: int = 0,
                use_kernel: str = "auto", max_colors: int = 8,
                j_dtype: str = "float32", r_hint: int = 0):
    """Pick the sweep engine for ``problem`` (an IsingProblem or an
    EllProblem).

    ``use_kernel`` (dense problems): "auto" runs the fused CUDA kernel when
    the problem lies on a CUDA device, "always" demands it (a CPU problem
    raises: the kernel has no interpret mode), "never" keeps the plain
    blocked sweep. ``j_dtype`` "bfloat16" makes the fused kernel sweep on J
    rounded to bfloat16 (the other engines keep float32, as in the JAX
    package). ``r_hint`` is the expected replica count: sparse problems
    on a CUDA device with r_hint >= SPARSE_T_MIN_REPLICAS_CUDA take the
    transposed engine and its kernels.
    """
    from spinglass_tpu_torch.kernels.sparse import (EllProblem,
                                                    SortedSparseEngine,
                                                    SortedSparseTEngine,
                                                    SparseEngine)

    update_rule = sweep_kernels.canonical_rule(update_rule)
    if use_kernel not in ("auto", "always", "never"):
        raise ValueError(f"use_kernel must be auto|always|never, got {use_kernel!r}")
    if j_dtype not in J_DTYPES:
        raise ValueError(f"j_dtype must be one of {J_DTYPES}, got {j_dtype!r}")

    def _sorted(p):
        if sweep_method == "sparse_t" or (
                sweep_method in ("auto", "sparse")
                and r_hint >= SPARSE_T_MIN_REPLICAS_CUDA
                and p.device.type == "cuda"):
            return SortedSparseTEngine(p, rule=update_rule)
        return SortedSparseEngine(p, rule=update_rule)

    if sweep_method == "sparse_compact":
        return SparseEngine(problem, rule=update_rule)
    if isinstance(problem, EllProblem):
        return _sorted(problem)
    n = problem.n_spins
    j_np = None
    if sweep_method in ("sparse", "sparse_t"):
        return _sorted(problem)
    if sweep_method == "auto" and n >= SPARSE_MIN_SPINS:
        j_np = problem.j[:n, :n].cpu().numpy()
        if topology.density(j_np) < SPARSE_DENSITY_THRESHOLD:
            return _sorted(problem)
    if sweep_method in ("auto", "colored"):
        if j_np is None:
            j_np = problem.j[:n, :n].cpu().numpy()
        try:
            colors = topology.greedy_coloring(
                j_np, max_colors=max_colors if sweep_method == "auto" else 256)
            n_colors = int(colors.max()) + 1 if colors.size else 1
            if sweep_method == "colored" or n_colors <= max_colors:
                return ColoredEngine(problem, colors, rule=update_rule)
        except ValueError:
            if sweep_method == "colored":
                raise
    elif sweep_method != "blocked":
        raise ValueError(f"unknown sweep_method {sweep_method!r}")
    if use_kernel == "always" and not problem.j.is_cuda:
        raise ValueError("use_kernel='always' needs a problem on a CUDA device; "
                         "the CUDA kernel has no CPU mode")
    if use_kernel == "always" or (use_kernel == "auto" and problem.j.is_cuda):
        return CudaFusedEngine(problem, block_size=block_size, rule=update_rule,
                               j_dtype=j_dtype)
    return BlockedEngine(problem, block_size=block_size or 128, rule=update_rule)
