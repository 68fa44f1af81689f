"""A plain PyTorch reference of parallel tempering on the 3-D
Edwards-Anderson +-J glass, independent of the port's layouts and kernels:
spins live on the lattice itself, [L, L, L, R] (replicas last), and every
neighbour is a ``torch.roll``. It imports neither ``spinglass_tpu`` nor
``spinglass_tpu_torch``.

* ``couplings``: J [3, L, L, L], J[d][x] the bond from site x to its +1
  neighbour along axis d (periodic), drawn +-1 with p = 1/2 from
  ``np.random.default_rng(seed)``, axis by axis and on each axis site by
  site in C order; site (x, y, z) is number x L^2 + y L + z.
* ``energies``: E = -sum over bonds of J s s', float64.
* ``sweep``: a checkerboard sweep, the even sublattice (x + y + z even)
  first, on given uniforms in lattice order: site x of replica r flips iff
  u[x, r] < exp(-beta dE) (Metropolis) or 1 / (1 + exp(beta dE)) (heat
  bath), dE = 2 s h.
* ``exchange``: the nearest-neighbour exchange pass of each chain on given
  uniforms: slots k and k + 1 (k of the pass's parity) swap iff u < exp((b_k
  - b_{k+1}) (E_k - E_{k+1})), E_k the energy of the replica at slot k.
* ``overlaps``: q_ab(t) = (1/N) sum_x s_x^a s_x^b of the replicas of chains
  a < b that hold slot t, [T, P], pairs in (a, b) lexicographic order.

Products and sums run in float64 with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

DIMS = 3


def exact() -> None:
    """Full-precision products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


exact()


def couplings(L: int, seed: int, device="cpu") -> torch.Tensor:
    """J [3, L, L, L] float64 of the periodic lattice of side L."""
    v = np.random.default_rng(seed).choice([-1.0, 1.0], DIMS * L ** DIMS)
    return torch.as_tensor(v.reshape((DIMS,) + (L,) * DIMS), device=device)


def coo(j: torch.Tensor):
    """(n, rows, cols, vals) of J, both directions of every bond."""
    L = j.shape[1]
    idx = np.arange(L ** DIMS).reshape((L,) * DIMS)
    a = np.concatenate([idx.ravel()] * DIMS)
    b = np.concatenate([np.roll(idx, -1, axis=d).ravel() for d in range(DIMS)])
    v = j.cpu().numpy().reshape(-1)
    return (L ** DIMS, np.concatenate([a, b]), np.concatenate([b, a]),
            np.concatenate([v, v]))


def lattice(spins_rn: torch.Tensor, L: int) -> torch.Tensor:
    """[R, N] spins in site order -> [L, L, L, R] float64."""
    return spins_rn.to(torch.float64).t().reshape((L,) * DIMS + (-1,))


def local_fields(j: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """h [L, L, L, R]: the sum of J s over the six neighbours."""
    h = torch.zeros_like(s)
    for d in range(DIMS):
        jd = j[d][..., None]
        h += jd * torch.roll(s, -1, d) + torch.roll(jd, 1, d) * torch.roll(s, 1, d)
    return h


def energies(j: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[R] float64 energies of s [L, L, L, R]."""
    e = torch.zeros(s.shape[-1], dtype=torch.float64, device=s.device)
    for d in range(DIMS):
        e -= (j[d][..., None] * s * torch.roll(s, -1, d)).sum(dim=(0, 1, 2))
    return e


def even_sites(L: int, device="cpu") -> torch.Tensor:
    """[L, L, L, 1] bool: x + y + z even."""
    x = torch.arange(L, device=device)
    par = x[:, None, None] + x[None, :, None] + x[None, None, :]
    return (par % 2 == 0)[..., None]


def sweep(j: torch.Tensor, s: torch.Tensor, beta: torch.Tensor,
          u: torch.Tensor, rule: str) -> torch.Tensor:
    """One checkerboard sweep of s [L, L, L, R] at beta [R] on uniforms u
    [L, L, L, R]; returns the new spins."""
    even = even_sites(s.shape[0], s.device)
    beta = beta.to(torch.float64)
    u = u.to(torch.float64)
    for part in (even, ~even):
        de = 2.0 * s * local_fields(j, s)
        if rule == "metropolis":
            p = torch.exp(-beta * de)
        elif rule in ("heat_bath", "glauber"):
            p = 1.0 / (1.0 + torch.exp(beta * de))
        else:
            raise ValueError(rule)
        s = torch.where(part & (u < p), -s, s)
    return s


def exchange(energy: torch.Tensor, slot: torch.Tensor, betas: torch.Tensor,
             u: torch.Tensor, parity: int) -> torch.Tensor:
    """One nearest-neighbour exchange pass of each of the C chains (replica
    c T + i in chain c) on uniforms u [C, T - 1]; returns the new slots."""
    n_chains, t = u.shape[0], betas.shape[0]
    slot = slot.clone()
    e = energy.to(torch.float64)
    b = betas.to(torch.float64)
    for c in range(n_chains):
        base = c * t
        at = {int(slot[base + i]): base + i for i in range(t)}
        for k in range(parity, t - 1, 2):
            x, y = at[k], at[k + 1]
            if float(u[c, k]) < float(torch.exp((b[k] - b[k + 1]) * (e[x] - e[y]))):
                slot[x], slot[y] = k + 1, k
    return slot


def overlaps(s: torch.Tensor, slot: torch.Tensor,
             n_chains: int) -> torch.Tensor:
    """q [T, P] float64 of spins s [..., R] (sites first) and slot [R]."""
    flat = s.reshape(-1, s.shape[-1]).to(torch.float64)
    t = flat.shape[1] // n_chains
    at = [{int(slot[c * t + i]): c * t + i for i in range(t)}
          for c in range(n_chains)]
    pairs = [(a, b) for a in range(n_chains) for b in range(a + 1, n_chains)]
    q = torch.zeros(t, len(pairs), dtype=torch.float64)
    for k in range(t):
        for p, (a, b) in enumerate(pairs):
            q[k, p] = (flat[:, at[a][k]] * flat[:, at[b][k]]).mean()
    return q
