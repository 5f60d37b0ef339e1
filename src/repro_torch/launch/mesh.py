"""Meshes over a world of ranks, after ``repro.launch.mesh``.

The reference builds a ``jax.sharding.Mesh`` over the devices its one
process sees.  The port builds a ``torch.distributed`` ``DeviceMesh``
over the ranks of an initialised world (``distributed.world``): each
rank is one device of the mesh, and each named axis has its process
group (``mesh.get_group(name)``).  Building a mesh is a collective: every
rank of the world calls the same function.

  * ``make_dev_mesh(model_parallel)``: (ranks / mp, mp) over
    ``("data", "model")``;
  * ``make_fleet_mesh(max_devices)``: the largest power-of-two prefix of
    the ranks on a ``("fleet",)`` axis (replica batches are pow2-bucketed,
    so a non-pow2 axis would never tile them); ranks past the prefix hold
    no coordinate (``mesh.get_coordinate()`` is None) and take no part in
    the fleet;
  * ``make_production_mesh(multi_pod)``: (16, 16) over ``("data",
    "model")`` or (2, 16, 16) over ``("pod", "data", "model")``, for a
    world of exactly 256 or 512 ranks.

Each takes the mesh's ``device_type``; None is "cuda" in an NCCL world
or a process that has used its CUDA card (``distributed.world`` sets a
rank's card), else "cpu".  Any initialised world serves: one of
``distributed.world``, ``torchrun``'s, or a plain
``init_process_group``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _world_size(what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(f"{what}: no process group; start a world with "
                           f"repro_torch.distributed.world (init_world or "
                           f"spawn)")
    return dist.get_world_size()


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    on_card = dist.get_backend() == "nccl" or (
        torch.cuda.is_available() and torch.cuda.is_initialized())
    return "cuda" if on_card else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = _world_size("make_production_mesh")
    need = math.prod(shape)
    if n != need:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{need} ranks, this one has {n}")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_dev_mesh(model_parallel: int = 1, *,
                  device_type: Optional[str] = None) -> DeviceMesh:
    """(ranks / model_parallel, model_parallel) over ("data", "model")."""
    n = _world_size("make_dev_mesh")
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not tile a model axis of "
                         f"{model_parallel}")
    return init_device_mesh(_device_type(device_type),
                            (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def make_fleet_mesh(max_devices: Optional[int] = None, *,
                    device_type: Optional[str] = None) -> DeviceMesh:
    """1-D ``("fleet",)`` mesh over the largest power-of-two prefix of the
    world's ranks (at most ``max_devices``)."""
    n = _world_size("make_fleet_mesh")
    if max_devices is not None:
        n = min(n, max_devices)
    n = 1 << (n.bit_length() - 1)       # largest pow2 <= n
    return DeviceMesh(_device_type(device_type), torch.arange(n),
                      mesh_dim_names=("fleet",))
