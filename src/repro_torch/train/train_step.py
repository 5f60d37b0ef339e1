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
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

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
    return TrainState(params=params, opt=optimizer.init(params),
                      comp=compressor.init(params) if compressor else None)


def _grads(loss: torch.Tensor, flat: list) -> list:
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(gs, flat)]


def make_train_step(model: LM, optimizer: AdamW, *, microbatches: int = 1,
                    compressor: Optional[Int8Compressor] = None,
                    remat: bool = True):
    """Returns step(state, batch) -> (state, metrics); ``batch`` a dict
    of tensors on the model's device."""

    def grads_of(params: Tree, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, list]:
        flat = parts(params)
        if microbatches == 1:
            loss = model.loss(batch, remat=remat)
            return loss.detach(), _grads(loss, flat)
        tot_loss = torch.zeros((), dtype=torch.float32, device=model.device)
        acc = None
        for i in range(microbatches):
            mb = {k: x[i * (x.shape[0] // microbatches):
                       (i + 1) * (x.shape[0] // microbatches)]
                  for k, x in batch.items()}
            loss = model.loss(mb, remat=remat)
            g = _grads(loss, flat)
            tot_loss = tot_loss + loss.detach()
            if acc is None:
                acc = [x.float() for x in g]
            else:
                for a, x in zip(acc, g):
                    a.add_(x.float())
        scale = 1.0 / microbatches
        return tot_loss * scale, [a * scale for a in acc]

    def step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        loss, flat = grads_of(state.params, batch)
        grads = from_parts(state.params, flat)
        comp = state.comp
        if compressor is not None and comp is not None:
            grads, comp = compressor.roundtrip(grads, comp)
        with torch.no_grad():
            gn = global_norm(grads)
        params, opt = optimizer.update(grads, state.opt, state.params)
        return (TrainState(params, opt, comp),
                {"loss": loss, "grad_norm": gn})

    return step

