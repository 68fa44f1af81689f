"""Ising problem container, the PyTorch counterpart of ``spinglass_tpu.core.problem``.

Conventions (identical to the JAX package):
    E(s)        = -1/2 * s^T J s - h^T s            (s in {-1,+1}^N)
    field_i(s)  = sum_j J_ij s_j + h_i
    dE(flip i)  = 2 * s_i * field_i(s)

J is stored dense, symmetric and zero on the diagonal, padded to a multiple of
128 spins exactly as the JAX package pads it, so the padded arrays of the two
packages compare element for element. The tensors live on one device, and
every function of the port that takes a problem works on that device. The
constructors build on the card unless the caller names a device
(``resolve_device``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from spinglass_tpu_torch.core import rng

# The JAX package pads spin counts to the TPU lane width; the port keeps the
# same padding so problems, spins and uniforms line up 1:1 with the reference.
LANE = 128


def round_up(x: int, m: int = LANE) -> int:
    return ((x + m - 1) // m) * m


def resolve_device(device=None) -> torch.device:
    """The device a public constructor builds on: ``device`` where the
    caller names one, else the card. Without a card the default raises; it
    never carries on on the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port builds problems on the card by "
            'default; pass device="cpu" to build on the CPU')
    return torch.device("cuda")


@dataclass(frozen=True)
class IsingProblem:
    """Ising/QUBO problem on one device.

    Attributes:
      j: [Np, Np] symmetric coupling matrix, zero diagonal; padded rows and
         columns are zero.
      h: [Np] external fields, zero on padding.
      active_mask: [Np] float {0, 1}; padded spins have mask 0 and are never
         flipped.
      n_spins: the logical spin count (<= Np).
    """

    j: torch.Tensor
    h: torch.Tensor
    active_mask: torch.Tensor
    n_spins: int

    @property
    def n_padded(self) -> int:
        return self.j.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.j.device

    # ---- constructors -----------------------------------------------------

    @staticmethod
    def from_dense(
        j,
        h=None,
        *,
        dtype: torch.dtype = torch.float32,
        pad: bool = True,
        validate: bool = True,
        device=None,
    ) -> "IsingProblem":
        """Build a problem from a dense coupling matrix on ``device`` (None:
        the card, see ``resolve_device``).

        Symmetrises J as (J + J^T)/2, zeroes the diagonal, and pads to a
        multiple of 128 spins, in float64 on the host before the single cast
        to ``dtype``, as the JAX package does.
        """
        device = resolve_device(device)
        j = np.asarray(j, dtype=np.float64)
        if j.ndim != 2 or j.shape[0] != j.shape[1]:
            raise ValueError(f"J must be square, got {j.shape}")
        n = j.shape[0]
        if validate and not np.all(np.isfinite(j)):
            raise ValueError("J contains non-finite entries")
        j = 0.5 * (j + j.T)
        np.fill_diagonal(j, 0.0)
        if h is None:
            h = np.zeros((n,), dtype=np.float64)
        else:
            h = np.asarray(h, dtype=np.float64)
            if h.shape != (n,):
                raise ValueError(f"h must have shape ({n},), got {h.shape}")
            if validate and not np.all(np.isfinite(h)):
                raise ValueError("h contains non-finite entries")
        n_pad = round_up(n) if pad else n
        jp = np.zeros((n_pad, n_pad), dtype=np.float64)
        jp[:n, :n] = j
        hp = np.zeros((n_pad,), dtype=np.float64)
        hp[:n] = h
        mask = np.zeros((n_pad,), dtype=np.float64)
        mask[:n] = 1.0
        return IsingProblem(
            j=torch.as_tensor(jp, dtype=dtype, device=device),
            h=torch.as_tensor(hp, dtype=dtype, device=device),
            active_mask=torch.as_tensor(mask, dtype=dtype, device=device),
            n_spins=n,
        )

    @staticmethod
    def from_terms(
        n_spins: int,
        quad_i,
        quad_j,
        quad_val,
        lin_i=None,
        lin_val=None,
        *,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> "IsingProblem":
        """Build from sparse term lists: J[i, j] += v and J[j, i] += v for
        each quadratic term, h[i] += v for each linear term."""
        qi = np.asarray(quad_i, dtype=np.int64)
        qj = np.asarray(quad_j, dtype=np.int64)
        qv = np.asarray(quad_val, dtype=np.float64)
        j = np.zeros((n_spins, n_spins), dtype=np.float64)
        np.add.at(j, (qi, qj), qv)
        np.add.at(j, (qj, qi), qv)
        np.fill_diagonal(j, 0.0)
        h = np.zeros((n_spins,), dtype=np.float64)
        if lin_i is not None:
            np.add.at(h, np.asarray(lin_i, dtype=np.int64),
                      np.asarray(lin_val, dtype=np.float64))
        # from_dense halves (J + J^T); the matrix is already symmetric.
        return IsingProblem.from_dense(j, h, dtype=dtype, validate=False,
                                       device=device)

    # ---- serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        """Logical (unpadded) J and h as numpy arrays."""
        n = self.n_spins
        return {
            "n_spins": n,
            "j": self.j[:n, :n].cpu().numpy(),
            "h": self.h[:n].cpu().numpy(),
        }

    @staticmethod
    def from_dict(d: dict, *, dtype: torch.dtype = torch.float32,
                  device=None) -> "IsingProblem":
        return IsingProblem.from_dense(d["j"], d["h"], dtype=dtype,
                                       device=device)

    def save(self, path: str) -> None:
        """Compressed ``.npz`` in the JAX package's format (n_spins, j, h)."""
        d = self.to_dict()
        np.savez_compressed(path, n_spins=d["n_spins"], j=d["j"], h=d["h"])

    @staticmethod
    def load(path: str, *, dtype: torch.dtype = torch.float32,
             device=None) -> "IsingProblem":
        with np.load(path) as z:
            return IsingProblem.from_dense(z["j"], z["h"], dtype=dtype,
                                           device=device)


def random_spins(generator: torch.Generator, shape: tuple,
                 mask: Optional[torch.Tensor] = None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Uniform random spins in {-1, +1}; padded positions forced to +1.

    The draw runs on the generator's device; the result lies on ``mask``'s
    device when a mask is given. ``generator`` may also be a random tape's
    generator (``core.rng.device_generator`` under a captured step).
    """
    bits = rng.random_bits(generator, shape)
    s = (2 * bits - 1).to(dtype)
    if mask is not None:
        s = s.to(mask.device)
        s = torch.where(mask > 0, s, torch.ones_like(s))
    return s
