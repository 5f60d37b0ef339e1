"""Explicit collectives of the port's per-rank functions, in place of the
reference's ``psum`` and ``shard_map`` specs.

``gloo`` is the backend of ranks that share a card (and of the CPU);
it takes CUDA tensors and stages them through the host itself.  NCCL
needs a card a rank.

An autograd pair carries the reference's ``shard_map`` differentiation
(Megatron's f and g):

  * ``copy_to_group(x, group)``: identity forward; the backward sums the
    gradient over the group.  An input every rank of the group holds
    whole, feeding a computation each rank does only its part of.
  * ``reduce_from_group(x, group)``: the forward sums the partial
    results over the group; the backward passes the (replicated)
    gradient through unchanged.  ``torch.distributed.nn.functional``'s
    ``all_reduce`` sums it again in the backward, ``group``-size times
    too large for a replicated consumer.
  * ``sum_over_group(x, group)``: the forward sums over the group, and
    so does the backward: the sum of values that each rank then uses in
    its own way (the sum of squares of a Mamba2 block's gated norm over
    its channel shards).

The collectives are ``torch.distributed._functional_collectives``
(``_c10d_functional`` ops), which the op counter (``roofline.op_cost``)
sees and charges by kind; ``gather(x, dim, group)`` serves
forward-only code (the decode's merge).

``gloo`` on CUDA tensors: its all-reduce stages them through the host
itself, but its all-gather into one tensor (``all_gather_into_tensor``,
what DTensor's Shard-to-Replicate redistribution calls) kills the
process (a segmentation fault, PyTorch 2.11 on an H100).
``stage_through_host()``, which ``distributed.world`` calls when it
starts a gloo world on the card, makes the functional all-gather,
reduce-scatter and all-to-all copy a CUDA input to the host, run the
collective there and copy the result back: explicit and for gloo worlds
on the card only (NCCL worlds and the CPU are untouched).
"""
from __future__ import annotations

from typing import Optional

import functools

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) stacked along dim 0 in
    group-rank order, on ``t``'s device."""
    n = dist.get_world_size(group)
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather(list(out.chunk(n)), t.contiguous(), group=group)
    return out


# the functional collectives a gloo world on the card stages through the
# host (all_gather_single and reduce_scatter_single are the newer names)
_HOST_STAGED = ("all_gather_tensor", "all_gather_single",
                "reduce_scatter_tensor", "reduce_scatter_single",
                "all_to_all_single")


def _staged(fn):
    @functools.wraps(fn)
    def run(x, *args, **kwargs):
        if x.device.type != "cuda":
            return fn(x, *args, **kwargs)
        out = funcol.wait_tensor(fn(x.cpu(), *args, **kwargs))
        return out.to(x.device)
    run.host_staged = True
    return run


def stage_through_host() -> None:
    """Make ``_HOST_STAGED``'s functional collectives copy CUDA inputs to
    the host and back (a gloo world on the card); idempotent."""
    for name in _HOST_STAGED:
        fn = getattr(funcol, name, None)
        if fn is not None and not getattr(fn, "host_staged", False):
            setattr(funcol, name, _staged(fn))


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    fn = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
    return fn(x, dim, group)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The group's ``op`` ("sum", "max") of ``x``, a new tensor."""
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), op, group))


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order
    (no gradient)."""
    out = _all_gather(x.contiguous(), 0, group)
    out = funcol.wait_tensor(out)
    if dim == 0:
        return out
    n = out.shape[0] // x.shape[0]
    return torch.cat(out.chunk(n), dim=dim)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def copy_to_group(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: Optional[object]
                      ) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def sum_over_group(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    return _SumOverGroup.apply(x, group)
