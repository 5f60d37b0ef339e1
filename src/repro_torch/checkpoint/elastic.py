"""Elastic resharding: resume a checkpoint on another mesh, after
``repro.checkpoint.elastic``.

The manifest stores full (unsharded) leaves, so resuming on a new
topology is: restore the full leaves, then keep this rank's shard under
the same logical rules (``sharding.param_specs``) on the NEW mesh.  The
reference re-places the leaves with the new shardings
(``restore(..., shardings=...)``); in the port's world of ranks every
rank restores the manifest's leaves and keeps its own block.  Writing
stays on one rank (``distributed.fault_tolerance``: rank 0 saves,
every rank waits at a barrier).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..distributed import sharding as shd
from ..pytree import Leaf, tree_map
from . import checkpointer as ckpt

Tree = Any


def restore_on_mesh(ckpt_path, template_params: Tree, mesh
                    ) -> Tuple[int, Tree]:
    """(step, this rank's shards of the parameters) for ``mesh`` (a
    ``DeviceMesh`` with any shape over the same axis names): the
    template's structure, each leaf cut by ``param_specs`` (a copy, so the
    full leaves can be dropped)."""
    step, full = ckpt.restore(ckpt_path, template_params)
    return step, tree_map(
        lambda x: x.map(torch.clone) if isinstance(x, Leaf) else x.clone(),
        shd.local_params(full, mesh))
