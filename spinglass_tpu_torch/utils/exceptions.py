"""Exception taxonomy (the part of ``spinglass_tpu.utils.exceptions`` the
port raises), copied: the port imports nothing of the JAX package."""

from __future__ import annotations


class SpinGlassError(Exception):
    """Base error for the framework."""


class CheckpointError(SpinGlassError):
    """Checkpoint save/load failure."""
