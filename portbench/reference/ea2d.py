"""The 2-D random Ising glass of ``ea2d-l80`` (Santoro, Martonak, Tosatti &
Car, Science 295:2427, 2002; Martonak, Santoro & Tosatti, PRB 66:094203,
2002) and a plain PyTorch reference of simulated quantum annealing
(path-integral Monte Carlo quantum annealing) on it, independent of the
program's layouts and kernels: a copy of the reference that the
repository's tests keep beside their CPU tests
(``tests/torch_reference/sqa2d.py``), with the benchmark's ``build`` and
its own chains. Spins live on the lattice itself: a classical state is [R,
L, L], a Trotter state [R, P, L, L] (slice p is imaginary time p), and
every neighbour is a ``torch.roll``. Nothing here imports the program or
the JAX package.

* ``couplings``: J [2, L, L] float64, J[d][x, y] the bond from site (x, y)
  to its +1 neighbour along axis d (periodic), uniform in (-scale, scale)
  from ``np.random.default_rng(seed)``, axis by axis and on each axis site
  by site in C order (site (x, y) is number x L + y); ``coo`` gives both
  directions of every bond, the arrays the program builds its problem from.
* ``energies``: E = -sum over bonds of J s s' of classical states.
* ``j_perp``: J_perp = -(1 / (2 beta)) ln tanh(beta Gamma / P).
* ``action``: E_eff = (1/P) sum_p E(s_p) - J_perp sum_p sum_i s_p,i
  s_p+1,i of Trotter states, periodic in p (one bond between the two slices
  of P = 2, none for P = 1).
* ``sweep``: a checkerboard Metropolis sweep of the Trotter lattice, the
  sites with p + x + y even first, on given uniforms [R, P, L, L] in
  lattice order: a site flips iff u < exp(-beta dE), dE = 2 s h, h = (1/P)
  sum of J s over its four space neighbours + J_perp (s_p-1 + s_p+1).
* ``linear_gammas``: Gamma_k = Gamma_0 (1 - k / S), k = 0 .. S - 1.
* ``sqa``: the carried loop (the state continues from stage to stage),
  returning the state after every stage.
* ``decode``: every replica's P slice energies; ``correlation``: the mean
  slice-to-slice product of each replica.
* ``build``: the configuration's sample as COO arrays for the program and
  J on the lattice for the reference, hash checked, with its best-known
  energy; ``schedule_chains``: the reference's own carried SQA chains over
  a cell's schedule, run on the card in blocks, for the schedule check.

Products and sums run in float64 with TF32 off (``exact``), unless a caller
passes states of another dtype (the chains sweep in float32; the
lower-precision control passes bfloat16).
"""

from __future__ import annotations

import hashlib
import json
import math
import os

import numpy as np
import torch

DIMS = 2
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def exact() -> None:
    """Full-precision products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def couplings(L: int, seed: int, scale: float = 2.0,
              device="cpu") -> torch.Tensor:
    """J [2, L, L] float64 of the periodic square lattice of side L."""
    v = np.random.default_rng(seed).uniform(-scale, scale, DIMS * L * L)
    return torch.as_tensor(v.reshape(DIMS, L, L), device=device)


def coo(j: torch.Tensor):
    """(n, rows, cols, vals) of J, both directions of every bond."""
    L = j.shape[1]
    idx = np.arange(L * L).reshape(L, L)
    a = np.concatenate([idx.ravel()] * DIMS)
    b = np.concatenate([np.roll(idx, -1, axis=d).ravel() for d in range(DIMS)])
    v = j.cpu().numpy().reshape(-1)
    return (L * L, np.concatenate([a, b]), np.concatenate([b, a]),
            np.concatenate([v, v]))


def lattice(spins: torch.Tensor, L: int, n_trotter: int = 0) -> torch.Tensor:
    """[R, N] spins in site order -> [R, L, L]; [R, P N] in the Trotter
    order (slice p holds spins p N .. p N + N - 1) -> [R, P, L, L]."""
    if n_trotter:
        return spins.reshape(spins.shape[0], n_trotter, L, L)
    return spins.reshape(spins.shape[0], L, L)


def space_field(j: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The sum of J s over the four space neighbours of every site of s
    [..., L, L] (the last two axes are x and y)."""
    h = torch.zeros_like(s)
    for d in range(DIMS):
        ax = s.dim() - DIMS + d
        jd = j[d].to(s.dtype)
        h += jd * torch.roll(s, -1, ax) + torch.roll(jd, 1, d) * torch.roll(
            s, 1, ax)
    return h


def energies(j: torch.Tensor, s: torch.Tensor,
             dtype=torch.float64) -> torch.Tensor:
    """Energies of s [..., L, L] (one per leading index), computed in
    ``dtype`` (float64; the lower-precision control passes bfloat16)."""
    s, j = s.to(dtype), j.to(dtype)
    e = torch.zeros(s.shape[:-DIMS], dtype=dtype, device=s.device)
    for d in range(DIMS):
        ax = s.dim() - DIMS + d
        e -= (j[d] * s * torch.roll(s, -1, ax)).sum(dim=(-2, -1))
    return e


def j_perp(beta: float, gamma: float, n_trotter: int) -> float:
    return -0.5 / beta * math.log(math.tanh(beta * gamma / n_trotter))


def _time_weight(n_trotter: int) -> float:
    """The time bonds' multiplicity under a roll along p: each bond twice
    for P >= 3 read both ways, so 1; P = 2 has one bond that both rolls
    read, so 1/2; P = 1 none."""
    return 0.0 if n_trotter == 1 else 0.5 if n_trotter == 2 else 1.0


def correlation(s: torch.Tensor) -> torch.Tensor:
    """[R] float64: each Trotter state's mean over its time bonds of s s'
    (1 where the slices agree)."""
    s = s.to(torch.float64)
    p = s.shape[1]
    if p == 1:
        return torch.ones(s.shape[0], dtype=torch.float64, device=s.device)
    bonds = p if p > 2 else 1
    prod = (s * torch.roll(s, -1, 1)).sum(dim=(1, 2, 3))
    return _time_weight(p) * prod / (bonds * s[0, 0].numel())


def action(j: torch.Tensor, s: torch.Tensor, jp: float,
           dtype=torch.float64) -> torch.Tensor:
    """[R] E_eff of Trotter states s [R, P, L, L] at J_perp jp, computed in
    ``dtype`` (float64; the lower-precision control passes bfloat16)."""
    s = s.to(dtype)
    p = s.shape[1]
    t = (s * torch.roll(s, -1, 1)).sum(dim=(1, 2, 3))
    return energies(j, s, dtype).sum(dim=1) / p - jp * _time_weight(p) * t


def parity(p: int, L: int, device="cpu") -> torch.Tensor:
    """[P, L, L] bool: p + x + y even."""
    a = torch.arange(max(p, L), device=device)
    par = a[:p, None, None] + a[None, :L, None] + a[None, None, :L]
    return par % 2 == 0


def sweep(j: torch.Tensor, s: torch.Tensor, beta: float, jp: float,
          u: torch.Tensor) -> torch.Tensor:
    """One checkerboard Metropolis sweep of Trotter states s [R, P, L, L]
    on uniforms u [R, P, L, L], in s's dtype; returns the new states."""
    p, L = s.shape[1], s.shape[2]
    even = parity(p, L, s.device)
    w = _time_weight(p)
    for part in (even, ~even):
        h = space_field(j, s) / p
        if w:
            h = h + (w * jp) * (torch.roll(s, 1, 1) + torch.roll(s, -1, 1))
        flip = part & (u < torch.exp(-beta * 2.0 * s * h))
        s = torch.where(flip, -s, s)
    return s


def linear_gammas(gamma0: float, n_stages: int) -> np.ndarray:
    return gamma0 * (1.0 - np.arange(n_stages) / n_stages)


def sqa(j: torch.Tensor, s0: torch.Tensor, beta: float, gammas,
        sweeps_per_stage: int, uniforms) -> list:
    """The carried SQA loop from Trotter states s0 [R, P, L, L]: at stage k
    ``sweeps_per_stage`` sweeps at J_perp(Gamma_k), sweep t reading
    ``uniforms(t)`` ([R, P, L, L]). Returns the state after every stage."""
    p = s0.shape[1]
    s, t, out = s0, 0, []
    for gamma in gammas:
        jp = j_perp(beta, float(gamma), p)
        for _ in range(sweeps_per_stage):
            s = sweep(j, s, beta, jp, uniforms(t))
            t += 1
        out.append(s)
    return out


def decode(j: torch.Tensor, s: torch.Tensor, dtype=torch.float64):
    """(e [R, P] the classical energies of every replica's slices, least
    [R] the least of each)."""
    e = energies(j, s, dtype)
    return e, e.min(dim=1).values


def instance_hash(rows, cols, vals) -> str:
    """sha256 over rows as int64, cols as int64 and vals as float64 bytes."""
    h = hashlib.sha256()
    for a, dtype in ((rows, np.int64), (cols, np.int64), (vals, np.float64)):
        h.update(np.ascontiguousarray(np.asarray(a).astype(dtype)).tobytes())
    return h.hexdigest()


def provenance(name: str) -> dict:
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


def build(cfg: dict, seed: int, device) -> dict:
    """The configuration's disorder sample (its own seed, never the run's),
    hash checked where the configuration records one, as COO arrays for the
    program and as J on the lattice for the reference; its best-known
    energy where the record gives one. ``seed`` drives nothing here."""
    del seed
    spec = cfg["instance"]
    if spec.get("dims", DIMS) != DIMS or not spec.get("periodic", True) \
            or spec.get("dist", "uniform") != "uniform":
        raise ValueError("the reference holds the periodic 2-D lattice with "
                         "uniform couplings only")
    L = int(spec["L"])
    j = couplings(L, int(spec["seed"]), float(spec.get("scale", 2.0)), device)
    n, rows, cols, vals = coo(j)
    want = spec.get("sha256")
    if want is not None and instance_hash(rows, cols, vals) != want:
        raise RuntimeError(f"the lattice's hash differs from the "
                           f"configuration's {want}")
    out = {"kind": "coo", "n": n, "rows": rows, "cols": cols, "vals": vals,
           "lattice": {"L": L, "j": j}}
    best = spec.get("best_known_energy")
    if best is None and "record" in cfg:
        rec = provenance(os.path.basename(cfg["record"]))
        if rec["instance"]["sha256"] == want:
            best = rec["best_known_energy"]
    if best is not None:
        out["ground_energy"] = float(best)
    return out


def random_sigma(j: torch.Tensor) -> float:
    """The deviation of E over uniformly random spins: sqrt(sum of J^2)
    over the bonds."""
    return float(torch.sqrt((j.double() ** 2).sum()))


def schedule_chains(j: torch.Tensor, p: dict, chains: int, block: int,
                    seed: int):
    """The reference's own carried SQA over a cell's schedule (``p``:
    ``n_trotter``, ``beta``, ``gamma_start``, ``n_stages``,
    ``sweeps_per_stage``; the linear ramp): ``chains`` replicas from random
    spins, ``block`` at a time, on j's device, sweeping in float32 on
    uniforms from a generator there. Returns (least slice energy [chains]
    float64, slice-to-slice correlation [chains] float64) of the final
    states."""
    exact()
    L, dev = j.shape[1], j.device
    n_t = int(p["n_trotter"])
    gammas = linear_gammas(float(p["gamma_start"]), int(p["n_stages"]))
    g = torch.Generator(device=dev).manual_seed(int(seed))
    jf = j.to(torch.float32)
    least, corr = [], []
    for b0 in range(0, chains, block):
        r = min(block, chains - b0)
        s0 = (2.0 * torch.randint(0, 2, (r, n_t, L, L), generator=g,
                                  device=dev) - 1.0).to(torch.float32)
        final = sqa(jf, s0, float(p["beta"]), gammas,
                    int(p["sweeps_per_stage"]),
                    lambda t: torch.rand(s0.shape, generator=g,
                                         device=dev))[-1]
        least.append(decode(j, final)[1])
        corr.append(correlation(final))
    return torch.cat(least).cpu(), torch.cat(corr).cpu()
