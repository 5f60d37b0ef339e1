"""Ambient distribution context, after ``repro.distributed.context``.

Callers (``train.loop.train`` with a mesh, a launcher) install the
active ``DeviceMesh`` here; a layer whose multi-device form differs
picks it up (today the MoE dispatch, ``models.moe``).  With no mesh
installed every layer takes its one-process path.

``global_batch`` says that each rank's tokens are its ``(pod, data)``
block of one batch whose layers the reference runs over the whole of it
(its ``train(mesh=...)``, which installs no mesh): an MoE layer then
takes its capacity and queue places over the whole batch.  Without it a
layer works on the rank's tokens alone, as the reference's ``shard_map``
does on its shard.

The reference also wraps ``shard_map`` here.  The port has no such
wrapper: it is multi-controller, so a layer's multi-device form is a
per-rank function with explicit collectives over the mesh's process
groups (``distributed.collectives``), which each rank runs on its own.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

_ACTIVE_MESH = None
_GLOBAL_BATCH = False


def set_mesh(mesh, global_batch: bool = False) -> None:
    global _ACTIVE_MESH, _GLOBAL_BATCH
    _ACTIVE_MESH, _GLOBAL_BATCH = mesh, global_batch


def get_mesh() -> Optional[object]:
    return _ACTIVE_MESH


def global_batch() -> bool:
    return _GLOBAL_BATCH


@contextmanager
def use_mesh(mesh, global_batch: bool = False):
    prev = get_mesh(), _GLOBAL_BATCH
    set_mesh(mesh, global_batch)
    try:
        yield
    finally:
        set_mesh(*prev)
