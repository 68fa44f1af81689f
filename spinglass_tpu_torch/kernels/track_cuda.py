"""The SA driver's best tracking, ``csrc/sa_track.cu``, and its plain
PyTorch twin.

After each sweep the SA driver brings every replica's state up to date:
its energy (the sweep's change added), its best energy and best spins
(where the new energy is strictly lower) and its acceptance rate.
``track_reference`` is that update as six PyTorch ops, the driver's own
before the kernel; the kernel does the same in one launch, bit for bit on
the card, and reads and writes only the improved replicas' spins, copying
them into ``best_spins`` in place. On the card the best spins are int8
(+-1 exact; ``start_best``) whatever the spins' type: a quarter of the
bytes of float32 spins to read and write.

``BestTrack`` runs the twin for tensors on the CPU and the kernel for
tensors on a CUDA device (a failed build or launch raises, never falls
back); each launch is counted in the launch ledger (``build.LAUNCHES``).
``copies`` [R] int32 counts,
per replica, the sweeps whose spins were copied since the last ``reset``
(the twin counts them too). Nothing is built at import.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from spinglass_tpu_torch.kernels.build import count_launches

KERNEL = "sa_track"
LAYOUTS = ("nr", "rn")


def track_reference(energy, de, best_energy, cnt, spins, best_spins,
                    layout: str, n_spins: int):
    """Twin of the kernel: energy, de, best_energy [R] float32, cnt [R]
    int32, spins and best_spins in ``layout`` ("nr": [rows, R], "rn": [R,
    rows]) -> (energy, best_energy, best_spins, acc_rate, improved), every
    one a new tensor."""
    energy = energy + de
    improved = energy < best_energy
    imp_b = improved[None, :] if layout == "nr" else improved[:, None]
    best_energy = torch.where(improved, energy, best_energy)
    best_spins = torch.where(imp_b, spins, best_spins)
    acc_rate = cnt.to(torch.float32) / n_spins
    return energy, best_energy, best_spins, acc_rate, improved


def start_best(spins: torch.Tensor) -> torch.Tensor:
    """A run's first best spins: a copy of ``spins``, int8 on the card (the
    kernel's best spins), in the spins' type on the CPU (the twin's)."""
    if spins.is_cuda:
        return spins.to(torch.int8, copy=True)
    return spins.clone()


def load_kernel() -> ctypes.CDLL:
    """Build (first use) and bind the kernel's library."""
    from spinglass_tpu_torch.kernels import build

    p, i = ctypes.c_void_p, ctypes.c_int
    lib = build.load(KERNEL)
    lib.sgt_sa_track.argtypes = [p, p, p, p, ctypes.c_float, p, p, p, p, p,
                                 p, i, i, i, i, p]
    lib.sgt_sa_track.restype = ctypes.c_int
    lib.sgt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sgt_cuda_error_string.restype = ctypes.c_char_p
    return lib


class BestTrack:
    """One engine's best tracking. ``self(energy, de, best_energy, cnt,
    spins, best_spins, layout, n_spins)`` -> (energy, best_energy,
    best_spins, acc_rate) after a sweep (see ``track_reference``). On the
    card best_spins (int8) is the tensor given, updated in place, and the
    [R] outputs are new tensors; on the CPU all four are new tensors."""

    def __init__(self):
        self.copies = None
        self._lib = None

    def _counts(self, energy: torch.Tensor) -> torch.Tensor:
        """``copies`` for the replicas of ``energy`` [R] on its device, made
        (zeroed) where it has another shape or device."""
        c = self.copies
        if c is None or c.shape != energy.shape or c.device != energy.device:
            self.copies = torch.zeros(energy.shape, dtype=torch.int32,
                                      device=energy.device)
        return self.copies

    def reset(self, energy: torch.Tensor) -> None:
        """Zero ``copies`` for the replicas of ``energy`` [R], in place
        where it has their shape and device, so that a captured step keeps
        counting into it."""
        self._counts(energy).zero_()

    def __call__(self, energy, de, best_energy, cnt, spins, best_spins,
                 layout: str, n_spins: int):
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
        self._counts(energy)
        if not spins.is_cuda:
            energy, best_energy, best_spins, acc_rate, improved = \
                track_reference(energy, de, best_energy, cnt, spins,
                                best_spins, layout, n_spins)
            self.copies += improved.to(torch.int32)
            return energy, best_energy, best_spins, acc_rate
        return self._launch(energy, de, best_energy, cnt, spins, best_spins,
                            layout, n_spins)

    def _launch(self, energy, de, best_energy, cnt, spins, best_spins,
                layout, n_spins):
        """The kernel's launch on the tensors' device (``copies`` already
        of their replica count there): checks what it takes, raises on the
        rest."""
        r = energy.shape[0]
        dev = spins.device
        shape = (spins.shape[0], r) if layout == "nr" else (r, spins.shape[-1])
        if spins.dtype not in (torch.float32, torch.int8) or \
                best_spins.dtype != torch.int8 or spins.dim() != 2 or \
                tuple(spins.shape) != shape or best_spins.shape != spins.shape \
                or not (spins.is_contiguous() and best_spins.is_contiguous()) \
                or best_spins.device != dev:
            raise ValueError(
                f"spins (float32 or int8) and best_spins (int8: start_best) "
                f"must be one contiguous {layout!r} shape for {r} replicas on "
                f"one device, got {tuple(spins.shape)} {spins.dtype} and "
                f"{tuple(best_spins.shape)} {best_spins.dtype}")
        vectors = (energy, de, best_energy, cnt)
        if any(v.shape != (r,) or v.device != dev or not v.is_contiguous()
               for v in vectors) or cnt.dtype != torch.int32 or any(
                   v.dtype != torch.float32 for v in vectors[:3]):
            raise ValueError("energy, de, best_energy must be [R] float32 and "
                             "cnt [R] int32, contiguous, on the spins' device")
        if self._lib is None:
            self._lib = load_kernel()
        e_out, b_out, acc = (torch.empty_like(energy) for _ in range(3))
        rows = spins.shape[0] if layout == "nr" else spins.shape[1]
        inv_n = float(np.float32(1.0) / np.float32(n_spins))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._lib.sgt_sa_track(
                energy.data_ptr(), de.data_ptr(), best_energy.data_ptr(),
                cnt.data_ptr(), inv_n, e_out.data_ptr(), b_out.data_ptr(),
                acc.data_ptr(), self.copies.data_ptr(), spins.data_ptr(),
                best_spins.data_ptr(), spins.element_size(),
                int(layout == "nr"), rows, r, stream)
        if err != 0:
            msg = self._lib.sgt_cuda_error_string(err).decode()
            raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err} "
                               f"({msg})")
        count_launches({KERNEL: 1})
        return e_out, b_out, best_spins, acc
