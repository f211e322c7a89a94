"""Mesh factories over ``torch.distributed`` (the JAX package's
``repro.launch.mesh``).

Functions, not module constants: importing this module touches no process
group. ``fake_process_group`` stands one process in for the 256 or 512
ranks of a production mesh (the dry run's). Both meshes are ``torch.distributed.device_mesh.DeviceMesh``es with
the reference's axis names and shapes; each axis has its own process group
(``mesh.get_group(axis)``). ``mesh_shape`` gives any mesh's ``{axis:
size}`` mapping, so the sharding rules engine runs on a ``DeviceMesh`` or
on a plain mapping (the counterpart of the reference's ``abstract_mesh``).
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Mapping, Optional, Union

import torch
import torch.distributed as dist

from repro_torch.utils.device import resolve_device


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, or of a plain mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _process_group(device: torch.device) -> int:
    """The world size, after creating a one-rank group (in-process store,
    NCCL on the card, gloo on the CPU) when none is initialized."""
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[Union[str, torch.device]] = None):
    """16×16 single-pod (256 ranks) or 2×16×16 multi-pod (512 ranks) over
    the initialized process group; a ``ValueError`` names the world size
    it needs when the group has fewer ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < need:
        raise ValueError(
            f"the {'multi-pod' if multi_pod else 'single-pod'} production "
            f"mesh {shape} needs a process group of {need} ranks; this one "
            f"has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


@contextmanager
def fake_process_group(world: int):
    """This process as rank 0 of a ``world``-rank group of the ``fake``
    backend (``torch.testing``'s ``FakeStore``: no peers, every collective
    returns at once), for the block: what the dry run lowers the production
    meshes over in one process, on the ``cpu`` mesh device. A
    ``RuntimeError`` when a group is already initialized."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_host_mesh(model: int = 1,
                   device: Optional[Union[str, torch.device]] = None):
    """(world / model, model) mesh ``("data", "model")`` over the process
    group's ranks, on the card unless ``device`` names another; a
    one-rank group is created when none is initialized."""
    dev = resolve_device(device)
    n = _process_group(dev)
    if n % model:
        raise ValueError(f"{n} ranks do not split into model axes of "
                         f"{model}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (n // model, model),
                            mesh_dim_names=("data", "model"))
