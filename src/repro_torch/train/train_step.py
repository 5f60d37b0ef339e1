"""Train step factory, after ``repro.train.train_step``: loss and
gradients, microbatch accumulation (in f32, in the reference's order),
the optional int8 gradient compression with error feedback, and AdamW.

The state is the reference's ``TrainState`` over the port's trees
(``pytree.Leaf`` leaves): ``params`` is ``weights.param_tree(model)``,
the model's own parameters, which ``AdamW.update`` writes in place; the
moments and the residual are trees of the same shape.  A step returns
the same state object with its step count advanced.  The gradients come
from ``torch.autograd.grad`` through ``LM.loss`` (the attention through
the flash kernel's backward on the card).  ``metrics["grad_norm"]`` is
the norm of the gradients after the compressor's roundtrip and before
AdamW's clipping, as in the reference.

With a mesh whose ``model`` axis is one rank (data parallelism over
``pod`` and ``data``; the parameters replicated on every rank) a step
averages the loss and every gradient over the batch shards in ONE
all-reduce over ``data`` (an f32 bucket), before the compressor.  Every
rank then takes the same compressor, norm and AdamW steps on the same
gradients, so the replicas stay equal.  A ``model`` axis of more than
one rank trains tensor-parallel only: ``make_train_step`` refuses it for
a model that ``distribute_model`` did not place.

With a model placed by tensor parallelism (``LM.mesh`` set,
``distributed.tensor_parallel``), the parameters and gradients are
DTensors and the batch is the global one: ``LM.loss`` is already the
global mean, each gradient comes back in its parameter's placement (a
``Partial`` one summed over the ranks that hold a part of it), and the
compressor, the norm and AdamW run through DTensor's dispatch on each
rank's shards (``init_state`` places the moments by ``opt_state_specs``
with ZeRO-1).  ``metrics`` hold plain tensors.

With tracing on (``obs.enable()``) a step is a ``train.step`` span (tag
``tokens``) holding ``train.forward`` (``LM.loss``), ``train.backward``
(the gradients) and ``train.optimizer`` (the clip norm and
``AdamW.update``), one forward and backward a microbatch.  The step never
waits on the device, so on a card these four spans also record device
edges (``Span.on_device``), which give each phase's device time once the
caller has synchronised.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from .. import obs
from ..distributed import tensor_parallel as tp
from ..distributed.sharding import axis_sizes, batch_axes, batch_axis_size
from ..models.transformer import LM
from ..models.weights import param_tree, params_from_numpy
from ..optim import (AdamW, AdamWState, CompressorState, Int8Compressor,
                     global_norm)
from ..pytree import from_parts, parts

Tree = Any


class TrainState(NamedTuple):
    params: Tree
    opt: AdamWState
    comp: Optional[CompressorState]


def init_state(model: LM, optimizer: AdamW, init=None,
               compressor: Optional[Int8Compressor] = None) -> TrainState:
    """The state of a model about to train: its weights from ``init`` (the
    reference's parameter tree as numpy arrays, ``weights.params_from_numpy``;
    or a ``torch.Generator`` on the model's device, ``LM.init_weights``;
    None keeps the weights the model has), gradients switched on, and
    fresh optimizer and compressor states."""
    if isinstance(init, torch.Generator):
        model.init_weights(init)
    elif init is not None:
        params_from_numpy(model, init)
        if model.device.type == "cpu":
            # params_from_numpy shares the arrays' memory on the CPU, and
            # training writes the parameters in place: not into the
            # caller's arrays
            for p in model.parameters():
                p.data = p.data.clone()
    model.requires_grad_(True)
    params = param_tree(model)
    placements = (tp.moment_placements(params, model.mesh)
                  if model.mesh is not None else None)
    return TrainState(params=params, opt=optimizer.init(params, placements),
                      comp=compressor.init(params) if compressor else None)


def _grads(loss: torch.Tensor, flat: list) -> list:
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    return [torch.zeros_like(p) if g is None else tp.grad_to_param(g, p)
            for g, p in zip(gs, flat)]


def _plain(x: torch.Tensor) -> torch.Tensor:
    return x.full_tensor() if tp.is_dtensor(x) else x


def _mesh_reduce(loss: torch.Tensor, grads: list, mesh
                 ) -> Tuple[torch.Tensor, list]:
    """The batch shards' mean loss and gradients: the loss and every
    gradient in one f32 bucket all-reduced over each batch axis of more
    than one rank (one all-reduce over ``data``)."""
    sizes = axis_sizes(mesh)
    flat = [g.reshape(-1).float() for g in grads]
    with obs.span("train.all_reduce", elements=1 + sum(map(len, flat))):
        bucket = torch.cat([loss.reshape(1).float()] + flat)
        for ax in batch_axes(mesh):
            if sizes[ax] > 1:
                dist.all_reduce(bucket, group=mesh.get_group(ax))
                obs.count("train_all_reduce_bytes", bucket.numel() * 4)
    bucket /= batch_axis_size(mesh)
    out = [x.view(g.shape).to(g.dtype) for g, x in
           zip(grads, bucket[1:].split([g.numel() for g in grads]))]
    return bucket[0], out


def make_train_step(model: LM, optimizer: AdamW, *, microbatches: int = 1,
                    compressor: Optional[Int8Compressor] = None,
                    remat: bool = True, mesh=None):
    """Returns step(state, batch) -> (state, metrics); ``batch`` a dict
    of tensors on the model's device (with ``mesh``, this rank's rows,
    ``data.shard_batch``'s; the caller installs the mesh,
    ``distributed.context``).  A model placed by tensor parallelism
    (``distribute_model``) holds its own mesh and takes the whole batch;
    ``mesh`` is then not read."""
    if (mesh is not None and model.mesh is None
            and axis_sizes(mesh).get("model", 1) > 1):
        raise ValueError(
            "a model axis of more than one rank trains tensor-parallel: "
            "place the model with distributed.tensor_parallel."
            "distribute_model")

    dev = model.device

    def loss_and_grads(batch: Dict[str, torch.Tensor], flat: list
                       ) -> Tuple[torch.Tensor, list]:
        with obs.span("train.forward").on_device(dev):
            loss = model.loss(batch, remat=remat)
        with obs.span("train.backward").on_device(dev):
            return loss.detach(), _grads(loss, flat)

    def grads_of(params: Tree, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, list]:
        flat = parts(params)
        if microbatches == 1:
            return loss_and_grads(batch, flat)
        tot_loss = torch.zeros((), dtype=torch.float32, device=model.device)
        acc = None
        for i in range(microbatches):
            mb = {k: x[i * (x.shape[0] // microbatches):
                       (i + 1) * (x.shape[0] // microbatches)]
                  for k, x in batch.items()}
            loss, g = loss_and_grads(mb, flat)
            tot_loss = tot_loss + loss
            if acc is None:
                acc = [x.float() for x in g]
            else:
                for a, x in zip(acc, g):
                    a.add_(x.float())
        scale = 1.0 / microbatches
        return tot_loss * scale, [a * scale for a in acc]

    def step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        with obs.span("train.step", tokens=batch["tokens"].numel()
                      ).on_device(dev), model.mesh_context():
            return _step(state, batch)

    def _step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        loss, flat = grads_of(state.params, batch)
        if mesh is not None and model.mesh is None:
            loss, flat = _mesh_reduce(loss, flat, mesh)
        grads = from_parts(state.params, flat)
        comp = state.comp
        if compressor is not None and comp is not None:
            grads, comp = compressor.roundtrip(grads, comp)
        with torch.no_grad(), obs.span("train.optimizer").on_device(dev):
            gn = global_norm(grads)
            params, opt = optimizer.update(grads, state.opt, state.params)
        return (TrainState(params, opt, comp),
                {"loss": _plain(loss), "grad_norm": _plain(gn)})

    return step

