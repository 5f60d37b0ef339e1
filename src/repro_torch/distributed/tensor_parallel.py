"""Tensor and context parallelism over DTensor: the port's counterpart of
the reference's automatic partitioning, which GSPMD derives from
``param_specs``, ``opt_state_specs``, ``batch_spec`` and
``cache_shardings`` (``repro/launch/dryrun.py``).

The port places the same trees by the same rules (``sharding``) as
DTensors over a ``DeviceMesh`` (``launch.mesh``), and the model's ops
run on them through DTensor's dispatch: a column-parallel matmul's
output is sharded over ``model``, a row-parallel one's is ``Partial``
and is summed (one all-reduce) where the layers turn it back into the
replicated residual stream (``replicate``).  What DTensor has no rule
for runs per rank in ``torch.distributed.tensor.experimental.local_map``
with explicit collectives: the hand-written attention kernels on the
rank's heads or its block of the sequence (``models.attention``), the
vocabulary-parallel embedding and cross-entropy (``models.layers``), the
Mamba2 block on the rank's heads (``models.mamba2``) and the
expert-parallel MoE layer (``models.moe``).

  * ``distribute_model(model, mesh, init)`` makes each parameter of an
    ``LM`` built on ``meta`` a DTensor parameter placed by
    ``param_specs`` (a stacked leaf's spec loses its first entry, the
    block axis, which the port holds as one parameter a layer), built
    from this rank's shard of each leaf, one leaf at a time: no rank
    ever holds the whole model.
  * ``batch_input(x, mesh)`` places an input (the same global tensor on
    every rank) by ``batch_spec``: the rank keeps its rows.
  * ``distribute_caches(caches, cfg, mesh, global_batch)`` places the
    decode caches by ``cache_shardings``.
  * ``moment_placements(params, mesh)`` places AdamW's moments by
    ``opt_state_specs`` (ZeRO-1 over ``data``).

Every rank of the mesh runs the same program (multi-controller); a
collective's group is a mesh axis.  The launchers and ``chip_smoke.py``
start the worlds (``distributed.world``).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)
from torch.distributed.tensor.experimental import local_map

from ..pytree import flatten
from . import sharding as shd

MODEL = "model"


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def mesh_dim(mesh, name: str) -> Optional[int]:
    names = tuple(mesh.mesh_dim_names)
    return names.index(name) if name in names else None


def model_size(mesh) -> int:
    return shd.axis_sizes(mesh).get(MODEL, 1)


def model_rank(mesh) -> int:
    """This rank's coordinate on ``model`` (0 without the axis)."""
    d = mesh_dim(mesh, MODEL)
    return 0 if d is None else mesh.get_local_rank(d)


def with_model(x: DTensor, placement) -> Tuple:
    """``x``'s placements with ``placement`` on the ``model`` mesh dim."""
    d = mesh_dim(x.device_mesh, MODEL)
    out = list(x.placements)
    if d is not None:
        out[d] = placement
    return tuple(out)


def on_model(x: DTensor) -> Any:
    """The placement of ``x`` on the ``model`` mesh dim."""
    d = mesh_dim(x.device_mesh, MODEL)
    return Replicate() if d is None else x.placements[d]


@contextmanager
def implicit_replication():
    """``torch.distributed.tensor.experimental.implicit_replication``
    (plain tensors meeting DTensors count as replicated), re-entrant: the
    flag is restored on exit, not cleared, so a step inside a step keeps
    it."""
    d = DTensor._op_dispatcher
    prev = d._allow_implicit_replication
    d._allow_implicit_replication = True
    try:
        yield
    finally:
        d._allow_implicit_replication = prev


def replicate(x):
    """``x`` with every ``Partial`` placement summed into ``Replicate``
    (the all-reduce after a row-parallel matmul); a plain tensor or an
    ``x`` without one as it is."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def _contiguous_strides(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def from_local(local: torch.Tensor, mesh, spec, shape) -> DTensor:
    """A DTensor of global ``shape`` placed by ``spec`` whose local shard
    on this rank is ``local``."""
    return DTensor.from_local(local, mesh, shd.placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def shard_input(x: torch.Tensor, mesh, spec) -> DTensor:
    """``x`` (the whole tensor, the same on every rank) as a DTensor
    placed by ``spec``: this rank keeps its block, a copy."""
    local = shd.local_shard(x, spec, mesh).clone(
        memory_format=torch.contiguous_format)
    return from_local(local, mesh, spec, x.shape)


def batch_input(x: torch.Tensor, mesh, batch_dim: int = 0) -> DTensor:
    """``x`` with its batch dim (``batch_dim``) placed by ``batch_spec``
    (sharded over pod and data when they divide it), replicated over
    ``model``; ``x`` is the global tensor."""
    spec = [None] * x.dim()
    bspec = shd.batch_spec(mesh, x.shape[batch_dim], 1)
    spec[batch_dim] = bspec[0]
    return shard_input(x, mesh, tuple(spec))


def run_local(fn, args: Sequence, in_placements: Sequence,
              out_placements, mesh, grad_placements=None):
    """``fn`` on the local shards of ``args`` (each redistributed to its
    entry of ``in_placements``; None for a non-tensor argument), its
    outputs DTensors placed by ``out_placements``; ``grad_placements``
    say how each input's local gradient is placed (``Partial`` where a
    replicated input's gradient is summed over ranks)."""
    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = (tuple(out_placements),)       # one output
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=(None if grad_placements is None
                                         else tuple(grad_placements)),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def grad_placements(in_placements, act: DTensor, model_partial: bool
                    ) -> Tuple:
    """How an input's local gradient inside ``run_local`` is placed, for
    an input placed by ``in_placements`` beside the activation ``act``:
    sharded where the input is, ``Partial`` over the mesh dims that shard
    ``act``'s batch (each rank's rows) and, with ``model_partial``, over
    ``model`` (a replicated input each rank applies to its own part),
    else ``Replicate``."""
    md = mesh_dim(act.device_mesh, MODEL)
    out = []
    for i, p in enumerate(in_placements):
        if isinstance(p, Shard):
            out.append(p)
        elif isinstance(act.placements[i], Shard) or (
                model_partial and i == md):
            out.append(Partial())
        else:
            out.append(Replicate())
    return tuple(out)


# ------------------------------------------------------------- parameters

def _named_params(model) -> Dict[int, Tuple[nn.Module, str]]:
    out = {}
    for mod in model.modules():
        for name, p in mod._parameters.items():
            if p is not None:
                out[id(p)] = (mod, name)
    return out


def param_part_specs(model, mesh) -> Dict[int, Tuple]:
    """{id(parameter): its spec}: ``param_specs`` of the reference's tree
    (``models.weights.param_tree``), a stacked leaf's spec without its
    block entry."""
    from ..models.weights import param_tree
    return _part_specs(param_tree(model),
                       lambda n, x: shd.param_spec(n, x, mesh))


def _part_specs(tree, spec_of) -> Dict[int, Tuple]:
    """{id(part): spec} of a tree of ``Leaf``s, ``spec_of(name, leaf)``
    the leaf's spec; a stacked leaf's parts lose its first entry."""
    boxes = shd._map_named(lambda n, x: _SpecBox(spec_of(n, x)), tree)
    out = {}
    for (_, leaf), (_, box) in zip(flatten(tree), flatten(boxes)):
        spec = box.spec
        spec = tuple(spec[1:]) if leaf.stacked and spec else spec
        for p in leaf.parts:
            out[id(p)] = spec
    return out


class _SpecBox:
    """A spec as one leaf of ``pytree.flatten`` (a tuple would be a
    node)."""
    __slots__ = ("spec",)

    def __init__(self, spec):
        self.spec = tuple(spec)


def distribute_model(model, mesh, init=None, device=None):
    """Place every parameter of ``model`` (an ``LM``, best built on
    ``meta``) on ``mesh`` by ``param_specs``, as DTensor parameters on
    ``device`` (None: the card in an NCCL or card world, else the CPU;
    ``"meta"`` for a count).  ``init`` gives the values, one leaf at a
    time in ``LM.init_weights``' order, so that no rank holds the whole
    model: the reference's tree of numpy arrays
    (``weights.seeded_numpy_params``), a ``torch.Generator`` on
    ``device`` (each leaf drawn whole as ``init_weights`` draws it, then
    cut), or None (the values the parameters hold, which must not be on
    ``meta``, or nothing on ``meta``).  Sets ``model.mesh``; returns
    ``model``."""
    from ..models import weights as W
    dev = torch.device(device) if device is not None else _mesh_device(mesh)
    specs = param_part_specs(model, mesh)
    where = _named_params(model)
    arrays = W.numpy_sources(model, init) if isinstance(init, dict) else {}
    for t, leaf_init in model._leaves():
        spec = specs[id(t)]
        shape = tuple(t.shape)
        if dev.type == "meta":
            full = None
            local_shape = _local_shape(shape, spec, mesh)
            local = torch.empty(local_shape, dtype=t.dtype, device=dev)
        else:
            full = _full_value(t, leaf_init, init, arrays, dev)
            local = shd.local_shard(full, spec, mesh).clone()
        del full
        mod, name = where[id(t)]
        dt = from_local(local, mesh, spec, shape)
        mod.register_parameter(name, nn.Parameter(
            dt, requires_grad=t.requires_grad))
    model.mesh = mesh
    model.device = dev
    return model


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    sizes = shd.axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in shd._axes(entry):
            out[d] //= sizes[a]
    return tuple(out)


def _full_value(t, leaf_init, init, arrays, dev) -> torch.Tensor:
    """One parameter's whole value on ``dev``: from the numpy tree, drawn
    from the generator as ``LM.init_weights`` draws it, or the
    parameter's own."""
    if isinstance(init, dict):
        return torch.from_numpy(np.ascontiguousarray(arrays[id(t)])).to(
            dev, t.dtype)
    if isinstance(init, torch.Generator):
        full = torch.empty(t.shape, dtype=t.dtype, device=dev)
        if leaf_init.scale is None:
            return full.fill_(1.0)
        if leaf_init.scale == 0:
            return full.zero_()
        return full.normal_(generator=init).mul_(leaf_init.scale)
    if t.device.type == "meta":
        raise ValueError("distribute_model: a model on meta needs init (a "
                         "numpy tree or a generator)")
    return t.detach().to(dev)


# ------------------------------------------------------------------ caches

def distribute_caches(caches, cfg, mesh, global_batch: int):
    """The caches of ``LM.init_caches`` (whole, on every rank) as DTensors
    placed by ``cache_shardings``: each rank keeps its block (a copy),
    which the decode steps update in place."""
    specs = shd.cache_shardings(cfg, caches, mesh, global_batch)
    out = type(caches)(
        {k: shard_input(v, mesh, spec[k]) for k, v in c.items()}
        for c, spec in zip(caches, specs))
    out.enc_out = getattr(caches, "enc_out", None)
    return out


def cache_seq_dims(cache: DTensor) -> Tuple[int, ...]:
    """The mesh dims over which a cache's sequence (dim 1) is sharded."""
    return tuple(i for i, p in enumerate(cache.placements)
                 if isinstance(p, Shard) and p.dim == 1)


def seq_block(cache: DTensor) -> Tuple[int, int]:
    """(start, length) of this rank's block of a cache's sequence."""
    mesh = cache.device_mesh
    idx, count = 0, 1
    for d in cache_seq_dims(cache):
        n = mesh.size(d)
        idx = idx * n + mesh.get_local_rank(d)
        count *= n
    length = cache.shape[1] // count
    return idx * length, length


# --------------------------------------------------------------- optimizer

def moment_placements(params, mesh, *, zero1: bool = True) -> Dict[int, Tuple]:
    """{id(parameter part): DTensor placements of its AdamW moments}:
    ``opt_state_specs`` (ZeRO-1: a moment's largest free dim also sharded
    over ``data``), a stacked leaf's spec without its block entry."""
    specs = _part_specs(params, lambda n, x: shd.opt_state_spec(
        n, x, mesh, zero1=zero1))
    return {k: shd.placements(spec, mesh) for k, spec in specs.items()}


def placed_zeros(p: DTensor, placements, dtype) -> DTensor:
    """Zeros of ``p``'s global shape in ``dtype`` placed by
    ``placements`` on ``p``'s mesh (a moment of ``p``)."""
    mesh = p.device_mesh
    spec_shape = list(p.shape)
    for d, pl in enumerate(placements):
        if isinstance(pl, Shard):
            spec_shape[pl.dim] //= mesh.size(d)
    local = torch.zeros(spec_shape, dtype=dtype, device=p.to_local().device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=p.shape,
                              stride=_contiguous_strides(p.shape))


def grad_to_param(g, p):
    """A gradient DTensor in its parameter's placements (a ``Partial``
    one summed); a plain gradient as it is."""
    if not is_dtensor(g) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)

