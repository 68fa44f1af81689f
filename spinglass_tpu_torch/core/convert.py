"""Carry problems and annealing state across from the JAX package.

The caller turns the JAX arrays into numpy (``np.asarray``) and passes them
here, so this module needs no JAX. Tests use it to make both packages anneal
the identical instance (dense or ELL) from the identical SA or PT state.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spinglass_tpu_torch.core.problem import IsingProblem


def problem_from_numpy(j, h, active_mask, n_spins: int,
                       device="cpu") -> IsingProblem:
    """Port problem from a JAX ``IsingProblem``'s padded arrays, unchanged
    (no second symmetrisation or padding)."""
    j = np.asarray(j, np.float32)
    if j.ndim != 2 or j.shape[0] != j.shape[1]:
        raise ValueError(f"J must be square, got {j.shape}")
    return IsingProblem(
        j=torch.tensor(j, device=device),
        h=torch.tensor(np.asarray(h, np.float32), device=device),
        active_mask=torch.tensor(np.asarray(active_mask, np.float32),
                                 device=device),
        n_spins=int(n_spins),
    )


def ell_from_numpy(idx, val, h, active_mask, n_spins: int, device="cpu"):
    """Port ``EllProblem`` from a JAX ``EllProblem``'s arrays, unchanged."""
    from spinglass_tpu_torch.kernels.sparse import EllProblem

    def t(x, dtype):
        return torch.tensor(np.asarray(x, dtype), device=device)

    return EllProblem(idx=t(idx, np.int32), val=t(val, np.float32),
                      h=t(h, np.float32), active_mask=t(active_mask, np.float32),
                      n_spins=int(n_spins))


def _in_layout(x, src_layout: str, layout: str, device,
               dtype=np.float32) -> torch.Tensor:
    for lay in (src_layout, layout):
        if lay not in ("rn", "nr"):
            raise ValueError(f"unknown spin layout {lay!r}")
    t = torch.tensor(np.asarray(x, dtype), device=device)
    if src_layout != layout:
        t = t.t()
    return t.contiguous()


def sa_state_from_numpy(spins, energy, best_energy, best_spins, temp,
                        acc_ema, sweep: int, acc_rate=None, *,
                        src_layout: str = "rn", layout: str = "rn",
                        device="cpu",
                        generator: Optional[torch.Generator] = None):
    """Port ``SAState`` from a JAX ``SAState``'s arrays.

    ``spins``/``best_spins`` arrive in ``src_layout`` (the JAX engine's:
    "rn" = [R, Np], "nr" = [Np, R]) and are stored in ``layout`` (the port
    engine's). The JAX PRNG key has no torch counterpart: the state gets
    ``generator``, or a new CPU generator seeded with 0.
    """
    from spinglass_tpu_torch.anneal.sa import SAState
    from spinglass_tpu_torch.anneal.schedules import ScheduleState

    def vec(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    energy = vec(energy)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return SAState(
        spins=_in_layout(spins, src_layout, layout, device),
        energy=energy,
        best_energy=vec(best_energy),
        best_spins=_in_layout(best_spins, src_layout, layout, device),
        sched=ScheduleState(temp=vec(temp).reshape(()),
                            acc_ema=vec(acc_ema).reshape(())),
        generator=generator,
        sweep=int(sweep),
        acc_rate=(torch.zeros_like(energy) if acc_rate is None
                  else vec(acc_rate)),
    )


def pt_state_from_numpy(spins, slot, energy, best_energy, best_spins,
                        sweep: int, exch_attempts, exch_accepts,
                        acc_rate=None, *, src_layout: str = "rn",
                        layout: str = "rn", spin_dtype=np.float32,
                        device="cpu",
                        generator: Optional[torch.Generator] = None):
    """Port ``PTState`` from a JAX ``PTState``'s arrays.

    Layouts as in ``sa_state_from_numpy``; a sorted [NS, R] state of the
    transposed sparse engine is "nr" on both sides. ``spin_dtype`` is the
    port engine's (int8 for the sparse engine's threshold path). The state
    gets ``generator``, or a new CPU generator seeded with 0."""
    from spinglass_tpu_torch.anneal.pt import PTState

    def vec(x, dtype=np.float32):
        return torch.tensor(np.asarray(x, dtype), device=device)

    energy = vec(energy)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return PTState(
        spins=_in_layout(spins, src_layout, layout, device, spin_dtype),
        slot=vec(slot, np.int32),
        energy=energy,
        best_energy=vec(best_energy),
        best_spins=_in_layout(best_spins, src_layout, layout, device,
                              spin_dtype),
        generator=generator,
        sweep=int(sweep),
        exch_attempts=vec(exch_attempts, np.int32),
        exch_accepts=vec(exch_accepts, np.int32),
        acc_rate=(torch.zeros_like(energy) if acc_rate is None
                  else vec(acc_rate)),
    )
