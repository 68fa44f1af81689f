"""The Sherrington-Kirkpatrick glass, drawn on the device from the seed.

J_ij ~ N(0, 1/N) for i < j, symmetric, zero diagonal, no field
(Sherrington & Kirkpatrick, PRL 35:1792, 1975). One upper triangle of
standard normals is drawn by a generator on the device in one call, mirrored
and scaled, so the same seed gives the same J on the same device, and the
matrix is exactly symmetric in float32.

``ground_energy_per_spin`` is the reference's estimate of the ground energy
of one instance: Parisi's -0.76317 per spin with the finite-size correction
E(N)/N = e_inf + a N^(-2/3), a ~ 0.7 (Boettcher, EPJ B 46:453, 2005; Aspelmeier,
Billoire, Marinari & Moore, J. Phys. A 41:324008, 2008).
"""

from __future__ import annotations

import math

import torch

E_INF = -0.76317
FINITE_SIZE = 0.7


def draw_j(n: int, seed: int, device) -> torch.Tensor:
    """[n, n] float32 J on ``device`` from ``seed`` (a whole number >= 0)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    a = torch.randn((n, n), generator=g, device=device, dtype=torch.float32)
    u = torch.triu(a, diagonal=1)
    del a
    return (u + u.T) * (1.0 / math.sqrt(n))


def ground_energy_per_spin(n: int) -> float:
    return E_INF + FINITE_SIZE * n ** (-2.0 / 3.0)


def build(cfg: dict, seed: int, device) -> dict:
    n = int(cfg["sizes"]["n_spins"])
    return {"kind": "dense", "n": n, "j": draw_j(n, seed, device),
            "ground_energy": ground_energy_per_spin(n) * n}
