"""Cluster updates, batched over replicas: Wolff and Swendsen-Wang.

The counterpart of ``spinglass_tpu.core.cluster``.

Wolff grows one cluster per replica from a random seed site. Each step adds
every non-cluster spin j with joint probability
    p_join(j) = 1 - prod_{i in frontier} (1 - p_ij),
    p_ij     = 1 - exp(-2 beta J_ij s_i s_j)   where J_ij s_i s_j > 0,
i.e. log(1 - p_join) = -2 beta sum_{i in frontier} max(J_ij s_i s_j, 0),
and the grown cluster flips as a whole. The dense step factors the sum into
two [R, N] x [N, N] products (max(J s_i s_j, 0) = |J|/2 + s_i s_j J/2 for
unit spins), run in full float32 (no TF32); the ELL step gathers each spin's
K neighbours. The JAX ``while_loop`` over frontier steps is a loop capped at
n_pad steps with one ``torch.any`` read per step: Wolff is a library
function, and no driver captures it.

``SwendsenWang`` activates every satisfied bond with p = 1 - exp(-2 beta
J s_i s_j) (one uniform per undirected edge: both directions read the draw
of the lower index's slot, found through ``_ell_reverse_slots``), bonds a
site to a ghost spin with p = 1 - exp(-2 beta h_i s_i) where h_i s_i > 0,
labels the clusters and flips each cluster not bonded to the ghost with a
coin of its own. On a CUDA tensor that is two launches, C2
(``csrc/sw_bonds.cu``: bond masks and start labels) and C1
(``csrc/sw_labels.cu``: labels and flips), through
``kernels/cluster_cuda.py``; they let the sweep run inside the PT driver's
captured super-step. On a CPU tensor the kernels' plain versions run, the
labelling through ``labeller(idx, bond, init)`` (the JAX loop). dE comes
from two ELL energies.

Randomness: ``sweep`` draws one kernel seed (``core.rng.draw_seed``: a seed
slot while a captured step's tape is active), from which C2 and C1 draw
Philox words; ``wolff_update`` draws from a device generator seeded by the
run's host generator (``core.rng``, so a captured step replays them from its
tape); ``sweep_with_draws`` / ``wolff_update_with_draws`` take the caller's
draws, which is how the tests hand the port the JAX package's.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch

from spinglass_tpu_torch.core import energy as energy_ops
from spinglass_tpu_torch.core import rng
from spinglass_tpu_torch.kernels import cluster_cuda
from spinglass_tpu_torch.kernels.sparse import EllProblem, sparse_energy


def _beta(beta, r: int, device) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(beta, dtype=torch.float32,
                                              device=device), (r,))


@contextlib.contextmanager
def _full_float32():
    """float32 products in full float32 (TF32 off) for the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _seed_sites(gen, r: int, n_spins: int, device) -> torch.Tensor:
    u = rng.rand(gen, (r,), device)
    return torch.clamp((u * n_spins).long(), max=n_spins - 1)


def _grow(spins: torch.Tensor, beta: torch.Tensor, active: torch.Tensor,
          seed_sites: torch.Tensor, uniform_at: Callable,
          join_prob: Callable):
    """Grow one cluster per replica from ``seed_sites`` [R] and flip it.
    ``join_prob(frontier, beta, spins)`` -> p_join [R, Np];
    ``uniform_at(step)`` -> the uniforms [R, Np] of frontier step ``step``.
    Returns (spins, size[R])."""
    r, n_pad = spins.shape
    cluster = torch.zeros(r, n_pad, dtype=torch.bool, device=spins.device)
    cluster[torch.arange(r, device=spins.device), seed_sites.long()] = True
    frontier = cluster.clone()
    step = 0
    while step < n_pad and bool(torch.any(frontier)):
        p_join = join_prob(frontier, beta, spins)
        newly = (uniform_at(step) < p_join) & ~cluster & active[None, :]
        cluster = cluster | newly
        frontier = newly
        step += 1
    return (torch.where(cluster, -spins, spins),
            torch.sum(cluster, dim=-1, dtype=torch.int32))


def _dense_join(problem):
    j32 = problem.j.to(torch.float32)
    jabs = torch.abs(j32)

    def join(frontier, beta, spins):
        fmask = frontier.to(torch.float32)
        with _full_float32():
            bond_sum = 0.5 * (fmask @ jabs) + 0.5 * spins * ((fmask * spins) @ j32)
        return 1.0 - torch.exp(-2.0 * beta[:, None] * bond_sum)

    return join


def _ell_join(ell: EllProblem):
    idx = ell.idx.long()

    def join(frontier, beta, spins):
        nb = torch.where(frontier, spins, torch.zeros_like(spins))[:, idx]
        jss = ell.val[None] * spins[:, :, None] * nb
        bond_sum = torch.sum(torch.clamp(jss, min=0.0), dim=-1)
        return -torch.expm1(-2.0 * beta[:, None] * bond_sum)

    return join


def wolff_update_with_draws(problem, spins: torch.Tensor, beta,
                            seed_sites: torch.Tensor, uniform_at: Callable):
    """One Wolff cluster flip per replica on a dense ``IsingProblem`` or an
    ``EllProblem``, from the caller's draws: seed sites [R] and
    ``uniform_at(step)`` -> [R, Np]. spins [R, Np]; returns (spins,
    cluster_size [R] int32)."""
    r = spins.shape[0]
    join = _ell_join(problem) if isinstance(problem, EllProblem) \
        else _dense_join(problem)
    return _grow(spins, _beta(beta, r, spins.device), problem.active_mask > 0,
                 seed_sites, uniform_at, join)


def wolff_update(problem, spins: torch.Tensor, beta,
                 generator: torch.Generator):
    """One Wolff cluster flip per replica (dense or ELL problem); draws from
    a device generator seeded by ``generator``."""
    gen = rng.device_generator(generator, spins.device)
    seeds = _seed_sites(gen, spins.shape[0], problem.n_spins, spins.device)
    return wolff_update_with_draws(
        problem, spins, beta, seeds,
        lambda step: rng.rand(gen, spins.shape, spins.device))


def _wolff_sweep(problem, energy_fn, spins, beta, generator, n_clusters: int):
    e0 = energy_fn(spins)
    total = torch.zeros(spins.shape[0], dtype=torch.int32, device=spins.device)
    for _ in range(n_clusters):
        spins, size = wolff_update(problem, spins, beta, generator)
        total = total + size
    return spins, energy_fn(spins) - e0, total


def wolff_sweep(problem, spins: torch.Tensor, beta,
                generator: torch.Generator, n_clusters: int = 1):
    """n_clusters Wolff updates on a dense problem; returns (spins, dE[R],
    total_flipped[R]). dE is recomputed exactly."""
    return _wolff_sweep(problem, lambda s: energy_ops.energy(problem, s),
                        spins, beta, generator, n_clusters)


def wolff_update_ell(ell: EllProblem, spins: torch.Tensor, beta,
                     generator: torch.Generator):
    """Sparse Wolff: one cluster flip per replica over ELL neighbour lists."""
    return wolff_update(ell, spins, beta, generator)


def wolff_sweep_ell(ell: EllProblem, spins: torch.Tensor, beta,
                    generator: torch.Generator, n_clusters: int = 1):
    """n_clusters sparse Wolff updates; returns (spins, dE[R], flipped[R])."""
    return _wolff_sweep(ell, lambda s: sparse_energy(ell, s), spins, beta,
                        generator, n_clusters)


# ---------------------------------------------------------------------------
# Swendsen-Wang
# ---------------------------------------------------------------------------

def _ell_reverse_slots(idx, val):
    """Host precompute: rev_i/rev_k such that idx[rev_i[i,k], rev_k[i,k]] == i
    for every real slot (self-pointing on padding). Lets both directions of an
    undirected edge consume the SAME uniform (the i<j direction's draw).
    Where row j holds i in several real slots, the first counts (as in the
    JAX function); sorted keys and a binary search instead of a loop."""
    idx = np.asarray(idx).astype(np.int64)
    real = np.asarray(val) != 0.0
    n_pad, k_max = idx.shape
    rows = np.broadcast_to(np.arange(n_pad)[:, None], idx.shape)
    slots = np.broadcast_to(np.arange(k_max)[None, :], idx.shape)
    rev_i = np.array(rows, dtype=np.int32)
    rev_k = np.array(slots, dtype=np.int32)
    if not real.any():
        return rev_i, rev_k
    # the first real slot of each (row j, neighbour i), keyed j * Np + i
    keys, first = np.unique((rows * n_pad + idx)[real], return_index=True)
    slot_of = slots[real][first]
    query = (idx * n_pad + rows)[real]            # (j, i) for slot (i, k)
    at = np.minimum(np.searchsorted(keys, query), len(keys) - 1)
    found = keys[at] == query
    ri, rk = rev_i[real], rev_k[real]
    ri[found] = idx[real][found]
    rk[found] = slot_of[at[found]]
    rev_i[real], rev_k[real] = ri, rk
    return rev_i, rev_k


class SwendsenWang:
    """Swendsen-Wang multi-cluster updates, batched over replicas, on a
    dense ``IsingProblem`` (converted to ELL once) or an ``EllProblem``
    (see the module docstring). ``bonds`` is C2 and ``labeller`` C1
    (``kernel_names``); ``last_rounds`` [R] holds the labelling rounds of
    the last sweep."""

    kernel_names = (cluster_cuda.BONDS_KERNEL, cluster_cuda.KERNEL_NAME)

    def __init__(self, problem):
        ell = problem if isinstance(problem, EllProblem) \
            else EllProblem.from_problem(problem)
        self.ell = ell
        self.problem = problem
        dev = ell.device
        rev_i, rev_k = _ell_reverse_slots(ell.idx.cpu().numpy(),
                                          ell.val.cpu().numpy())
        self.rev_i = torch.as_tensor(rev_i, dtype=torch.int32, device=dev)
        self.rev_k = torch.as_tensor(rev_k, dtype=torch.int32, device=dev)
        self._idx = ell.idx.to(torch.int32).contiguous()
        self._active = ell.active_mask > 0
        self.bonds = cluster_cuda.BondActivation(
            self._idx, ell.val, ell.h, self._active, self.rev_i, self.rev_k)
        self.labeller = cluster_cuda.ClusterLabels()
        self.last_rounds = None

    def sweep(self, spins: torch.Tensor, beta, generator: torch.Generator):
        """spins [R, Np] float32 -> (spins, dE[R], n_clusters[R]); the
        sweep's draws come from one seed of ``generator``."""
        return self._sweep(spins, beta, seed=rng.draw_seed(generator))

    def sweep_with_draws(self, spins: torch.Tensor, beta, u_dir, u_ghost,
                         coins):
        """One sweep on the caller's draws: bond uniforms u_dir [R, Np, K]
        (each edge reads its lower end's), ghost uniforms u_ghost [R, Np]
        and cluster coins [R, Np] bool."""
        return self._sweep(spins, beta, u_dir=u_dir.contiguous(),
                           u_ghost=u_ghost.contiguous(),
                           coins=coins.contiguous())

    def _sweep(self, spins, beta, u_dir=None, u_ghost=None, coins=None,
               seed=None):
        spins = spins.contiguous()
        beta = _beta(beta, spins.shape[0], spins.device).contiguous()
        masks, init = self.bonds(spins, beta, u_dir=u_dir, u_ghost=u_ghost,
                                 seed=seed)
        if spins.is_cuda:
            new_spins, n_clusters, _, self.last_rounds = self.labeller.flip(
                self._idx, masks, init, spins, coins=coins, seed=seed)
        else:   # C1's plain versions, the labelling through ``labeller``
            bond = cluster_cuda.unpack_masks(masks, self._idx.shape[1])
            labels, self.last_rounds = self.labeller(self._idx, bond, init)
            new_spins, n_clusters = cluster_cuda.flip_reference(
                spins, labels, init, coins=coins, seed=seed)
        de = (sparse_energy(self.ell, new_spins)
              - sparse_energy(self.ell, spins))
        return new_spins, de, n_clusters
