"""The comparisons that decide ``correct``: each number with its limit.

Every number is a gap that is 0 for a perfect answer and grows with the
fault, so a check passes where ``value <= limit``:

* ``energy_gap``: the largest relative gap between an energy the program
  reports and the float64 energy of the spins it reports with it (relative
  to the larger of the energy and the deviation of the energy over random
  spins);
* ``best_not_min``: how far the reported best energy lies from the least
  of the reported per-replica bests (exact: limit 0);
* ``quality_gap``: how far the worst reported replica lies above the
  instance's ground energy (its estimate), relative to it;
* ``target_gap``: how far a solve's best spins lie above its target,
  relative to it (the target is the configuration's: limit 0);
* ``unmoved``: replicas whose best energy lies inside the band of random
  spins, above -UNMOVED_SIGMAS deviations of the energy over random spins
  (a replica that the sweeps left alone; exact: limit 0).
"""

from __future__ import annotations

import torch

UNMOVED_SIGMAS = 6.0


def rel_gap(claimed: torch.Tensor, ref: torch.Tensor,
            floor: float) -> torch.Tensor:
    """|claimed - ref| / max(|ref|, floor) elementwise, in float64 on the
    host. ``floor`` is the deviation of the energy over random spins
    (``Couplings.random_sigma``): energies near 0, as those of random
    spins, are judged on that scale."""
    claimed = torch.as_tensor(claimed, dtype=torch.float64).cpu()
    ref = torch.as_tensor(ref, dtype=torch.float64).cpu()
    return (claimed - ref).abs() / ref.abs().clamp(min=floor)


def above(ref: torch.Tensor, level: float) -> torch.Tensor:
    """(ref - level) / |level|: how far energies lie above ``level``."""
    ref = torch.as_tensor(ref, dtype=torch.float64).cpu()
    return (ref - level) / abs(level)


def check(value: float, limit: float) -> dict:
    return {"value": float(value), "limit": float(limit)}


def table(checks: dict) -> str:
    """The compared numbers, one per line, each beside its limit."""
    return "\n".join(f"check {k}: {v['value']:.6g} (limit {v['limit']:.6g}) "
                     f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}"
                     for k, v in checks.items())
