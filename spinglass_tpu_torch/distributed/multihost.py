"""Multi-process set-up: a ``torch.distributed`` group and its device meshes.

The counterpart of ``spinglass_tpu.distributed.multihost``. The JAX module
brings up ``jax.distributed`` and builds ``Mesh``es over every device of
every process; here each process is one rank that drives one device (the
card, or the CPU), and a mesh is a ``DeviceMesh`` over the ranks:

  initialize(...)      — ``torch.distributed.init_process_group`` from the
                         arguments or torchrun's MASTER_ADDR / MASTER_PORT /
                         WORLD_SIZE / RANK; with neither, a one-rank group
                         on a free localhost port, so a mesh always exists
                         (as ``jax.devices()`` always does). NCCL for a CUDA
                         device, gloo for the CPU.
  replica_mesh(...)    — 1-D "replica" mesh over all ranks, rank order, so
                         rank r holds replica shard r.
  hybrid_mesh(...)     — 2-D ("host", "replica") mesh: hosts by
                         LOCAL_WORLD_SIZE (ranks per host), ranks within one.
  local_replica_slice  — this rank's slice of a replica-sharded batch.
  scaling_report       — the scaling-efficiency summary, as in JAX.

Scaling model: the PT sweep is parallel over replicas; per super-step only
the [R] energy and slot vectors cross ranks (``pt_sharded``), a few KB.
"""

from __future__ import annotations

import datetime
import gc
import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_DEVICE: Optional[torch.device] = None   # the device of this rank's group


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None, timeout_s: Optional[float] = None) -> dict:
    """Bring up this process's rank. ``coordinator_address`` "host:port"
    (else MASTER_ADDR:MASTER_PORT from the environment), ``num_processes``
    (else WORLD_SIZE, else 1) and ``process_id`` (else RANK, else 0). With
    no coordinator a one-rank group on a free localhost port. ``device``
    defaults to the card (``core.problem.resolve_device``); on a CUDA device
    the rank takes card LOCAL_RANK (else ``device``'s index) and the group
    is NCCL, on the CPU gloo. One collective runs at once, so NCCL's
    communicator exists before any step captures one. ``timeout_s`` bounds
    how long a collective waits for its peers (torch's default where None).
    A second call returns the summary of the group that is up. Returns a
    summary dict."""
    global _DEVICE
    from spinglass_tpu_torch.core.problem import resolve_device

    if not dist.is_initialized():
        dev = resolve_device(device)
        address = coordinator_address
        if address is None and "MASTER_ADDR" in os.environ \
                and "MASTER_PORT" in os.environ:
            address = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
        world = num_processes or int(os.environ.get("WORLD_SIZE", "0")) or 1
        rank = (process_id if process_id is not None
                else int(os.environ.get("RANK", "0")))
        if address is None:
            if world != 1:
                raise ValueError(f"{world} processes need a coordinator "
                                 f"address")
            address = f"localhost:{_free_port()}"
        if dev.type == "cuda":
            index = int(os.environ.get("LOCAL_RANK", dev.index or 0))
            dev = torch.device("cuda", index)
            torch.cuda.set_device(dev)
        extra = ({} if timeout_s is None else
                 {"timeout": datetime.timedelta(seconds=timeout_s)})
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://{address}",
                                world_size=world, rank=rank, **extra)
        _DEVICE = dev
        probe = torch.zeros(1, device=dev)
        dist.all_reduce(probe)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": 1,   # one rank drives one device
        "global_devices": dist.get_world_size(),
        "backend": dist.get_backend(),
        "device": str(device_of_group()),
    }


def device_of_group() -> torch.device:
    """This rank's device: the one ``initialize`` took (or, for a group
    brought up elsewhere, the current card under NCCL, else the CPU)."""
    if _DEVICE is not None:
        return _DEVICE
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shutdown() -> None:
    """Take this rank's group down (``destroy_process_group``). NCCL keeps
    a communicator alive while a captured CUDA graph holds its collectives,
    and destroying it then waits for ever (seen with 4 ranks on H100s): the
    drivers' cached captured steps (``graphs.clear_caches``) go first, so
    call this once the rank's own captured steps are dropped too."""
    global _DEVICE
    if dist.is_initialized():
        from spinglass_tpu_torch.anneal import graphs

        graphs.clear_caches()
        gc.collect()
        if _DEVICE is not None and _DEVICE.type == "cuda":
            torch.cuda.synchronize(_DEVICE)
        dist.destroy_process_group()
    _DEVICE = None


def replica_mesh(device=None, axis: str = "replica"):
    """1-D ``DeviceMesh`` over all ranks in rank order, axis ``axis``
    (``initialize`` first if no group is up)."""
    from torch.distributed.device_mesh import init_device_mesh

    initialize(device=device)
    return init_device_mesh(device_of_group().type,
                            (dist.get_world_size(),), mesh_dim_names=(axis,))


def hybrid_mesh(device=None, axes: tuple = ("host", "replica")):
    """2-D (n_hosts, ranks_per_host) ``DeviceMesh``: independent problems
    over hosts, replicas over the ranks of a host. Ranks per host come from
    LOCAL_WORLD_SIZE (torchrun), else all ranks are on one host."""
    from torch.distributed.device_mesh import init_device_mesh

    initialize(device=device)
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world)) or world
    if world % per_host:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"{per_host}")
    return init_device_mesh(device_of_group().type,
                            (world // per_host, per_host),
                            mesh_dim_names=tuple(axes))


def local_replica_slice(n_replicas: int) -> slice:
    """This rank's contiguous slice of a replica-sharded leading axis (for
    rank-local result IO; shards are in rank order in ``replica_mesh``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per = n_replicas // max(world, 1)
    return slice(rank * per, rank * per + per)


def scaling_report(flips_per_sec_per_host: Sequence[float],
                   baseline_rate: Optional[float] = None) -> dict:
    """Scaling-efficiency summary for N-host runs.

    ``baseline_rate``: the measured single-host throughput of the SAME
    per-host workload. When given, efficiency = total / (N * baseline) —
    true scaling efficiency vs one host. Without it, the first host's rate
    stands in as the baseline, which only measures load balance across the
    N hosts (it cannot see uniform slowdown)."""
    rates = np.asarray(list(flips_per_sec_per_host), float)
    if rates.size == 0:
        return {"n_hosts": 0, "efficiency": 0.0}
    # `is not None`, not truthiness: an explicit 0.0 baseline means the
    # single-host measurement FAILED and must surface as efficiency 0
    explicit = baseline_rate is not None
    base = float(baseline_rate) if explicit else float(rates[0])
    ideal = base * len(rates)
    return {
        "n_hosts": int(rates.size),
        "total_flips_per_sec": float(rates.sum()),
        "efficiency": float(rates.sum() / ideal) if ideal else 0.0,
        "baseline_flips_per_sec": base,
        "baseline_kind": ("measured_single_host" if explicit
                          else "first_host"),
        "per_host": rates.tolist(),
    }
