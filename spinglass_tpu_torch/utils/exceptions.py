"""Exception taxonomy, copied from ``spinglass_tpu.utils.exceptions``: the
port imports nothing of the JAX package."""

from __future__ import annotations


class SpinGlassError(Exception):
    """Base error for the framework."""


class ModelError(SpinGlassError):
    """Invalid Ising model construction or state."""


class AnnealingError(SpinGlassError):
    """Failure inside an annealing run."""


class DeviceError(SpinGlassError):
    """Device availability or placement problem."""


class ValidationError(SpinGlassError):
    """Input validation failure."""


class ConvergenceError(AnnealingError):
    """Run terminated without reaching the requested tolerance."""


class CheckpointError(SpinGlassError):
    """Checkpoint save/load failure."""


def handle_torch_errors(fn):
    """Wrap PyTorch runtime errors into the framework taxonomy (the JAX
    package's ``handle_jax_errors``, with CUDA for the TPU)."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except (FloatingPointError, OverflowError) as e:
            raise AnnealingError(f"numerical failure in {fn.__name__}: {e}")
        except RuntimeError as e:
            msg = str(e).lower()
            if "device" in msg or "cuda" in msg or "backend" in msg:
                raise DeviceError(str(e)) from e
            raise

    return wrapper
