"""Mesh construction over ``torch.distributed``.

JAX serves a mesh from one controller; ``torch.distributed`` runs one
process a rank, each calling the same code (SPMD). :func:`init_process_group`
starts the default group when nothing has: from ``torchrun``'s
``RANK`` / ``WORLD_SIZE`` when they are set, else a world of one on an
in-memory store (no port, no network), or on a caller's store (the CPU
tests give each rank a ``FileStore``). The backend is ``nccl`` on the card
and ``gloo`` on the CPU.

The meshes are functions, never module constants, so importing this
module touches no process group. Every mesh has the reference's axis
names: ``("data", "model")``, or ``("pod", "data", "model")`` for two
pods.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


def init_process_group(device: DeviceLike = None, *, store=None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       timeout_s: float = 600.0) -> Tuple[int, int]:
    """Start the default process group unless one is running; returns
    ``(rank, world size)``. ``store``, ``rank`` and ``world_size`` come
    from the caller (a ``FileStore`` a rank), else from ``torchrun``'s
    environment, else a world of one on a ``HashStore``. ``timeout_s``
    bounds every collective, so ranks that disagree fail instead of
    hanging."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    from_env = store is None and rank is None and "RANK" in os.environ
    if from_env:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    elif store is None:
        store, rank, world_size = dist.HashStore(), 0, 1
    if dev.type == "cuda":
        # Each rank's card before the group starts, so NCCL binds to it.
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if from_env:
        dist.init_process_group(backend, rank=rank, world_size=world_size,
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=store, rank=int(rank),
                                world_size=int(world_size), timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """The reference's target topology: one 16x16 pod (256 ranks) or two
    pods (512 ranks) with a leading "pod" axis for the inter-pod
    boundary."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    _, world = init_process_group(device)
    if world < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, have {world}: start one "
            f"process a device under torchrun")
    return DeviceMesh(_mesh_device_type(device),
                      torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def _mesh_device_type(device: DeviceLike) -> str:
    """The mesh's device type. A ``fake`` world (the dry run,
    ``launch/dryrun.py``) holds fake tensors only, so its ``cuda`` needs
    no card."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() == "fake":
        return torch.device("cuda" if device is None else device).type
    return resolve_device(device).type


def make_host_mesh(model_axis: Optional[int] = None,
                   device: DeviceLike = None):
    """A ``("data", "model")`` mesh over every rank of the default group
    (a world of one unless one was started): ``model_axis`` ranks (default
    1) on "model", the rest on "data"."""
    from torch.distributed.device_mesh import DeviceMesh

    _, world = init_process_group(device)
    m = model_axis or 1
    if world % m:
        raise ValueError(f"model axis {m} does not divide {world} ranks")
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(world).reshape(world // m, m),
                      mesh_dim_names=("data", "model"))
