"""C1, the Swendsen-Wang labelling kernel, and its plain PyTorch version.

``csrc/sw_labels.cu`` has no Pallas counterpart: the JAX package labels a
Swendsen-Wang sweep's clusters with a ``lax.while_loop``
(``spinglass_tpu/core/cluster.py:291``). The port's PT super-step runs the
sweep inside a CUDA graph, which cannot branch on the host, so the loop
runs to its fixed point inside one launch (the source says how, and why its
labels equal the JAX loop's).

``ClusterLabels(idx, bond, init)`` takes the ELL neighbour indices idx
[Np, K] int32, the active bonds bond [R, Np, K] (bool) and the start labels
init [R, Np] int32 (each site's index, -1 where it is ghost-bonded, Np on
padding) and returns (labels [R, Np] int32, rounds [R] int32). For CPU
tensors it runs ``labels_reference``, the JAX loop in PyTorch (its rounds
are the same for every replica); for CUDA tensors it launches the kernel or
raises, and adds one to ``launches``. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes

import torch

KERNEL_NAME = "sw_labels"


def labels_reference(idx: torch.Tensor, bond: torch.Tensor,
                     init: torch.Tensor):
    """The JAX labelling loop: min-label propagation over the bonds, then
    pointer jumping (the jump index clamped to Np - 1 as the JAX gather
    clamps it), until no label changes or Np rounds have run. Returns
    (labels [R, Np] int32, rounds: an int); one host read per round."""
    r, n = init.shape
    big = torch.tensor(n, dtype=torch.int32, device=init.device)
    rows = torch.arange(r, device=init.device)[:, None]
    idx = idx.long()
    lab, rounds = init.to(torch.int32), 0
    while rounds < n:
        nb = torch.where(bond, lab[:, idx], big)              # [R, Np, K]
        new = torch.minimum(lab, nb.min(dim=-1).values)
        jump = new[rows, new.clamp(0, n - 1).long()]
        new = torch.where(new >= 0, torch.minimum(new, jump), new)
        changed = bool(torch.any(new != lab))
        lab, rounds = new, rounds + 1
        if not changed:
            break
    return lab, rounds


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sgt_sw_labels.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.sgt_sw_labels.restype = ctypes.c_int
    lib.sgt_sw_labels_max_shared_sites.restype = ctypes.c_int
    lib.sgt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sgt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_kernel() -> ctypes.CDLL:
    """Build (first use) and bind C1's library."""
    from spinglass_tpu_torch.kernels import build

    return _bind(build.load(KERNEL_NAME))


class ClusterLabels:
    """C1 with its launch count (see the module docstring)."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def __call__(self, idx: torch.Tensor, bond: torch.Tensor,
                 init: torch.Tensor):
        r, n = init.shape
        if not init.is_cuda:
            lab, rounds = labels_reference(idx, bond, init)
            return lab, torch.full((r,), rounds, dtype=torch.int32)
        k = idx.shape[1]
        dev = init.device
        for name, t, dtype, shape in (("idx", idx, torch.int32, (n, k)),
                                      ("bond", bond, torch.bool, (r, n, k)),
                                      ("init", init, torch.int32, (r, n))):
            if (t.dtype != dtype or tuple(t.shape) != shape
                    or t.device != dev or not t.is_contiguous()):
                raise ValueError(f"{KERNEL_NAME}: {name} must be contiguous "
                                 f"{dtype} {shape} on {dev}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        if self._lib is None:
            self._lib = load_kernel()
        labels = torch.empty(r, n, dtype=torch.int32, device=dev)
        rounds = torch.empty(r, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._lib.sgt_sw_labels(
                idx.data_ptr(), bond.data_ptr(), init.data_ptr(),
                labels.data_ptr(), rounds.data_ptr(), n, k, r, stream)
        if err != 0:
            msg = self._lib.sgt_cuda_error_string(err).decode()
            raise RuntimeError(f"{KERNEL_NAME} launch failed: CUDA error "
                               f"{err} ({msg})")
        self.launches += 1
        return labels, rounds
