"""Input validators (reference utils/validation.py:11-511 + the spin/coupling/
temperature validators of security/input_validation.py:27-453).

Copied from ``spinglass_tpu.utils.validation``; ``validate_device_count``
counts the visible CUDA cards, and ``validate_problem`` reads the problem's
tensors to the host."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from spinglass_tpu_torch.utils.exceptions import ValidationError


def validate_finite(x, name: str = "array"):
    arr = np.asarray(x)
    if not np.all(np.isfinite(arr)):
        n_bad = int(np.sum(~np.isfinite(arr)))
        raise ValidationError(f"{name} has {n_bad} non-finite entries")
    return arr


def validate_spins(spins, n_spins: Optional[int] = None):
    """Spins must be exactly +-1 on logical sites."""
    arr = validate_finite(spins, "spins")
    core = arr[..., :n_spins] if n_spins is not None else arr
    if not np.all(np.abs(core) == 1.0):
        raise ValidationError("spins must be exactly -1 or +1")
    return arr


def validate_couplings(j, symmetric: bool = True, tol: float = 1e-5):
    arr = validate_finite(j, "couplings")
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
        raise ValidationError(f"couplings must be square 2D, got {arr.shape}")
    if symmetric and not np.allclose(arr, arr.T, atol=tol):
        raise ValidationError("couplings must be symmetric")
    if np.any(np.abs(np.diag(arr)) > tol):
        raise ValidationError("coupling diagonal must be zero")
    return arr


def validate_temperature(t, name: str = "temperature"):
    t = float(t)
    if not np.isfinite(t) or t <= 0:
        raise ValidationError(f"{name} must be finite and > 0, got {t}")
    return t


def validate_temperature_range(t_min: float, t_max: float):
    validate_temperature(t_min, "min_temp")
    validate_temperature(t_max, "max_temp")
    if t_min >= t_max:
        raise ValidationError(f"min_temp {t_min} must be < max_temp {t_max}")
    return t_min, t_max


def validate_positive_int(x, name: str = "value"):
    if not isinstance(x, (int, np.integer)) or x <= 0:
        raise ValidationError(f"{name} must be a positive int, got {x!r}")
    return int(x)


def validate_probability(p, name: str = "probability"):
    p = float(p)
    if not (0.0 <= p <= 1.0):
        raise ValidationError(f"{name} must be in [0, 1], got {p}")
    return p


def validate_device_count(required: int):
    import torch

    n = torch.cuda.device_count()
    if n < required:
        raise ValidationError(f"need {required} devices, have {n}")
    return n


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def validate_problem(problem) -> None:
    """Full problem health check (feeds utils/health.py)."""
    validate_couplings(_host(problem.j))
    validate_finite(_host(problem.h), "fields")
    if problem.n_spins <= 0 or problem.n_spins > problem.n_padded:
        raise ValidationError(
            f"n_spins {problem.n_spins} out of range (padded "
            f"{problem.n_padded})")
    mask = _host(problem.active_mask)
    if int(mask.sum()) != problem.n_spins:
        raise ValidationError("active_mask inconsistent with n_spins")
