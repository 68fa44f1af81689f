"""Plain energies of spin configurations, the yardstick of every cell.

E(s) = -1/2 s^T J s (no field in any configuration here). ``Couplings``
works in float64 from the instance as the benchmark made it, in blocks of
replicas so that it fits beside anything; with ``round_bf16`` it sums on
couplings rounded to bfloat16 (in float32): the lower precision that the
controls put in the program's place.
"""

from __future__ import annotations

import torch

BLOCK = 256   # replicas per block


class Couplings:
    """An instance's couplings on ``device`` in one dtype: a dense [n, n]
    matrix, or the COO arrays (each edge in both directions)."""

    def __init__(self, instance: dict, device, dtype=torch.float64,
                 round_bf16: bool = False):
        self.kind, self.n = instance["kind"], instance["n"]
        self.dtype = dtype
        if self.kind == "dense":
            j = instance["j"].to(device)
            if round_bf16:
                j = j.to(torch.bfloat16)
            self.j = j.to(dtype)
        elif self.kind == "coo":
            self.rows = torch.as_tensor(instance["rows"], device=device,
                                        dtype=torch.int64)
            self.cols = torch.as_tensor(instance["cols"], device=device,
                                        dtype=torch.int64)
            v = torch.as_tensor(instance["vals"], device=device,
                                dtype=torch.float64)
            if round_bf16:
                v = v.to(torch.bfloat16)
            self.vals = v.to(dtype)
        else:
            raise ValueError(f"unknown instance kind {self.kind!r}")

    def random_sigma(self) -> float:
        """The deviation of E over uniformly random spins:
        sqrt(sum_{i<j} J_ij^2)."""
        sq = self.j.pow(2).sum() if self.kind == "dense" else \
            self.vals.pow(2).sum()
        return float(torch.sqrt(0.5 * sq.double()))

    def energies(self, spins: torch.Tensor) -> torch.Tensor:
        """[R, n] spins (any dtype, values +-1) -> [R] energies in
        ``self.dtype``."""
        out = []
        for r0 in range(0, spins.shape[0], BLOCK):
            s = spins[r0:r0 + BLOCK, : self.n].to(self.dtype)
            if self.kind == "dense":
                quad = torch.sum(s * (s @ self.j), dim=1)
            else:
                quad = torch.sum(s[:, self.rows] * s[:, self.cols] * self.vals,
                                 dim=1)
            out.append(-0.5 * quad)
        return torch.cat(out)

