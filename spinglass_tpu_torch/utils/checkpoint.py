"""State checkpointing on ``torch.save``.

The counterpart of ``spinglass_tpu.utils.checkpoint``. A state tree
(dataclasses, dicts, lists and tuples holding tensors, numpy arrays, numpy
or Python scalars and ``torch.Generator``s) is flattened to a dict of
tensors keyed by each leaf's path and written with ``torch.save``; it is
read back with ``torch.load(weights_only=True)`` into the structure of a
template. A generator is stored as its ``get_state()`` and comes back as a
new generator in that state, on the template generator's device; tensors
come back on the template tensor's device.

``load_pytree`` checks every tensor leaf against the template: a shape or a
dtype kind that differs (a float spin array into an int8 layout) raises
``CheckpointError``, as the JAX loader does, where ``torch.load`` alone
would take it. Numpy and scalar leaves (host counters, recorded histories)
are cast to the template's dtype, and their shapes are not checked.

The JAX package writes an Orbax directory or an ``.npz``; the port has one
format (``ckpt_{step}.pt``), so ``CheckpointManager`` has no ``use_orbax``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch

from spinglass_tpu_torch.utils.exceptions import CheckpointError


def _children(tree):
    """(key, child) pairs of a container node, or None for a leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree) if f.init]
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _rebuild(tree, values: list):
    """``tree`` with its children replaced by ``values`` (same order)."""
    if dataclasses.is_dataclass(tree):
        names = [f.name for f in dataclasses.fields(tree) if f.init]
        return dataclasses.replace(tree, **dict(zip(names, values)))
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), values))
    return type(tree)(values)


def _flatten(tree, prefix: str = "") -> list:
    """(path, leaf) pairs of a state tree, in a fixed order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out.extend(_flatten(v, f"{prefix}/{k}"))
    return out


def _unflatten(template, leaves: iter):
    kids = _children(template)
    if kids is None:
        return next(leaves)
    return _rebuild(template, [_unflatten(v, leaves) for _, v in kids])


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(leaf, order="C", copy=True))
    if isinstance(leaf, (bool, int, float)):
        return torch.tensor(leaf)
    raise CheckpointError(f"cannot checkpoint a leaf of type {type(leaf)}")


def _kind(dtype: torch.dtype) -> str:
    """numpy's dtype kind of a torch dtype: b, f, c, u or i."""
    if dtype == torch.bool:
        return "b"
    if dtype.is_floating_point:
        return "f"
    if dtype.is_complex:
        return "c"
    return "u" if dtype in (torch.uint8, torch.uint16, torch.uint32,
                            torch.uint64) else "i"


def save_pytree(tree: Any, path: str) -> None:
    """Write a state tree to ``path`` (one ``torch.save`` of its leaves)."""
    flat = {key: _as_tensor(leaf) for key, leaf in _flatten(tree)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(flat, path)


def load_pytree(template: Any, path: str) -> Any:
    """Read ``path`` into the structure of ``template`` (see the module
    docstring for what is checked)."""
    stored = torch.load(path, map_location="cpu", weights_only=True)
    leaves = []
    for key, tmpl in _flatten(template):
        if key not in stored:
            raise CheckpointError(f"missing leaf {key} in {path}")
        value = stored[key]
        if isinstance(tmpl, torch.Generator):
            leaves.append(torch.Generator(device=tmpl.device).set_state(value))
        elif isinstance(tmpl, torch.Tensor):
            if tuple(value.shape) != tuple(tmpl.shape):
                raise CheckpointError(
                    f"leaf {key}: stored shape {tuple(value.shape)} != "
                    f"expected {tuple(tmpl.shape)} in {path} — the "
                    f"checkpoint was written under a different layout/config")
            if _kind(value.dtype) != _kind(tmpl.dtype):
                raise CheckpointError(
                    f"leaf {key}: stored dtype {value.dtype} is a different "
                    f"kind than expected {tmpl.dtype} in {path} — the "
                    f"checkpoint was written under a different engine layout")
            leaves.append(value.to(device=tmpl.device, dtype=tmpl.dtype))
        elif isinstance(tmpl, (bool, int, float)):
            leaves.append(type(tmpl)(value.item()))
        else:   # numpy arrays and scalars stay on the host, in their dtype
            arr = np.asarray(value.numpy(), dtype=np.asarray(tmpl).dtype)
            leaves.append(arr[()] if isinstance(tmpl, np.generic) else arr)
    return _unflatten(template, iter(leaves))


class CheckpointManager:
    """Periodic checkpoints ``ckpt_{step}.pt`` in ``directory``, the last
    ``keep`` of them kept."""

    def __init__(self, directory: str, every: int = 10, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def _steps(self) -> list:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_") and name.endswith(".pt"):
                stem = name[len("ckpt_"):-len(".pt")]
                if stem.isdigit():
                    steps.append(int(stem))
        return sorted(steps)

    def maybe_save(self, step: int, tree: Any) -> Optional[str]:
        """Save ``tree`` as step ``step`` when ``every`` divides it."""
        if step % self.every != 0:
            return None
        path = self._path(step)
        save_pytree(tree, path)
        self._gc()
        return path

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, template: Any) -> Optional[Any]:
        step = self.latest_step()
        if step is None:
            return None
        return load_pytree(template, self._path(step))

    def _gc(self) -> None:
        for s in self._steps()[: -self.keep]:
            os.remove(self._path(s))
