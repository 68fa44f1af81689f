"""The 3-D Edwards-Anderson +-J glass: the instance and a plain PyTorch
reference of parallel tempering on it, independent of the program's layouts
and kernels. Spins live on the lattice itself, [L, L, L, R] (replicas
last), and every neighbour is a ``torch.roll``; nothing here imports the
program or the JAX package (the same reference as the repository's tests
keep beside their CPU tests).

* ``couplings``: J [3, L, L, L], J[d][x] the bond from site x to its +1
  neighbour along axis d (periodic), +-1 with p = 1/2 from
  ``np.random.default_rng(seed)``, axis by axis and on each axis site by site
  in C order (site (x, y, z) is number x L^2 + y L + z); ``coo`` gives both
  directions of every bond, the arrays the program builds its problem from.
* ``energies``: E = -sum over bonds of J s s', float64.
* ``sweep``: a checkerboard sweep, the even sublattice (x + y + z even)
  first, on given uniforms in lattice order: a site flips iff u < exp(-beta
  dE) (Metropolis) or 1 / (1 + exp(beta dE)) (heat bath), dE = 2 s h.
* ``exchange``: each chain's nearest-neighbour exchange pass on given
  uniforms; ``overlaps``: q_ab(t) = (1/N) sum_x s_x^a s_x^b of the replicas
  of chains a < b at slot t, [T, P], pairs in lexicographic order.
* ``equilibrium_energy``: the reference's own heat-bath chains at fixed
  temperatures on the device, for the thermal check: the mean energy per
  spin at each.

Products and sums run in float64 with TF32 off (``exact``).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

DIMS = 3
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def exact() -> None:
    """Full-precision products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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


def instance_hash(rows, cols, vals) -> str:
    """sha256 over rows as int64, cols as int64 and vals as float64 bytes."""
    h = hashlib.sha256()
    for a, dtype in ((rows, np.int64), (cols, np.int64), (vals, np.float64)):
        h.update(np.ascontiguousarray(np.asarray(a).astype(dtype)).tobytes())
    return h.hexdigest()


def lattice(spins_rn: torch.Tensor, L: int) -> torch.Tensor:
    """[R, N] spins in site order -> [L, L, L, R] float64."""
    return spins_rn.to(torch.float64).t().reshape((L,) * DIMS + (-1,))


def local_fields(j: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """h [L, L, L, R]: the sum of J s over the six neighbours."""
    h = torch.zeros_like(s)
    for d in range(DIMS):
        jd = j[d][..., None].to(s.dtype)
        h += jd * torch.roll(s, -1, d) + torch.roll(jd, 1, d) * torch.roll(s, 1, d)
    return h


def energies(j: torch.Tensor, s: torch.Tensor,
             dtype=torch.float64) -> torch.Tensor:
    """[R] energies of s [L, L, L, R], computed in ``dtype`` (float64; the
    lower-precision control passes bfloat16)."""
    s, j = s.to(dtype), j.to(dtype)
    e = torch.zeros(s.shape[-1], dtype=dtype, device=s.device)
    for d in range(DIMS):
        e -= (j[d][..., None] * s * torch.roll(s, -1, d)).sum(dim=(0, 1, 2))
    return e


def even_sites(L: int, device="cpu") -> torch.Tensor:
    """[L, L, L, 1] bool: x + y + z even."""
    x = torch.arange(L, device=device)
    par = x[:, None, None] + x[None, :, None] + x[None, None, :]
    return (par % 2 == 0)[..., None]


def flip_probability(de: torch.Tensor, beta: torch.Tensor,
                     rule: str) -> torch.Tensor:
    if rule == "metropolis":
        return torch.exp(-beta * de)
    if rule in ("heat_bath", "glauber"):
        return 1.0 / (1.0 + torch.exp(beta * de))
    raise ValueError(rule)


def sweep(j: torch.Tensor, s: torch.Tensor, beta: torch.Tensor,
          u: torch.Tensor, rule: str) -> torch.Tensor:
    """One checkerboard sweep of s [L, L, L, R] at beta [R] on uniforms u
    [L, L, L, R], in s's dtype; returns the new spins."""
    even = even_sites(s.shape[0], s.device)
    beta = beta.to(s.dtype)
    for part in (even, ~even):
        p = flip_probability(2.0 * s * local_fields(j, s), beta, rule)
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
    slot = slot.cpu()
    at = [{int(slot[c * t + i]): c * t + i for i in range(t)}
          for c in range(n_chains)]
    pairs = [(a, b) for a in range(n_chains) for b in range(a + 1, n_chains)]
    q = torch.zeros(t, len(pairs), dtype=torch.float64)
    for k in range(t):
        cols_a = [at[a][k] for a, _ in pairs]
        cols_b = [at[b][k] for _, b in pairs]
        q[k] = (flat[:, cols_a] * flat[:, cols_b]).mean(dim=0).cpu()
    return q


def ladder(spec: dict) -> np.ndarray:
    """The temperatures of a ladder (cold -> hot), float64: ``n_replicas``
    from ``min_temp`` to ``max_temp``, spaced ``ladder`` (linear or
    geometric)."""
    lo, hi, n = spec["min_temp"], spec["max_temp"], spec["n_replicas"]
    if spec.get("ladder", "geometric") == "linear":
        return np.linspace(lo, hi, n)
    return np.geomspace(lo, hi, n)


def equilibrium_energy(j: torch.Tensor, temps: np.ndarray, chains: int,
                       burn: int, measure: int, rule: str,
                       seed: int) -> np.ndarray:
    """The reference's own chains: ``chains`` independent replicas at each
    of ``temps``, from random spins, ``burn`` checkerboard sweeps then
    ``measure`` sweeps with the energy taken after each, on j's device.
    Returns the mean energy per spin at each temperature [T]."""
    exact()
    L, dev = j.shape[1], j.device
    n = L ** DIMS
    g = torch.Generator(device=dev).manual_seed(int(seed))
    r = len(temps) * chains
    beta = torch.as_tensor(np.repeat(1.0 / np.asarray(temps), chains),
                           dtype=torch.float32, device=dev)
    s = (2.0 * torch.randint(0, 2, (L,) * DIMS + (r,), generator=g,
                             device=dev) - 1.0).to(torch.float32)
    jf = j.to(torch.float32)
    e_sum = torch.zeros(r, dtype=torch.float64, device=dev)
    for k in range(burn + measure):
        u = torch.rand(s.shape, generator=g, device=dev)
        s = sweep(jf, s, beta, u, rule)
        if k >= burn:
            e_sum += energies(j, s)
    per = (e_sum / (measure * n)).cpu().numpy().reshape(len(temps), chains)
    return per.mean(axis=1)


def provenance(name: str) -> dict:
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


def build(cfg: dict, seed: int, device) -> dict:
    """The configuration's disorder sample (its own seed, never the run's),
    hash checked where the configuration records one, as COO arrays for the
    program and as J on the lattice for the reference; its best-known
    energy where a record gives one. ``seed`` drives only the chains."""
    del seed
    spec = cfg["instance"]
    if not spec.get("periodic", True) or spec.get("dist", "binary") != "binary":
        raise ValueError("the reference holds the periodic +-J lattice only")
    j = couplings(int(spec["L"]), int(spec["seed"]), device)
    n, rows, cols, vals = coo(j)
    want = spec.get("sha256")
    if want is not None and instance_hash(rows, cols, vals) != want:
        raise RuntimeError(f"the lattice's hash differs from the "
                           f"configuration's {want}")
    out = {"kind": "coo", "n": n, "rows": rows, "cols": cols, "vals": vals,
           "lattice": {"L": int(spec["L"]), "j": j}}
    best = spec.get("best_known_energy")
    if best is None and "record" in cfg:
        rec = provenance(os.path.basename(cfg["record"]))
        if rec["instance"]["sha256"] == want:
            best = rec["best_known_energy"]
    if best is not None:
        out["ground_energy"] = float(best)
    return out
