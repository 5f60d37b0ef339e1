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
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) stacked along dim 0 in
    group-rank order, on ``t``'s device."""
    n = dist.get_world_size(group)
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather(list(out.chunk(n)), t.contiguous(), group=group)
    return out


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: Optional[object]
                      ) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)
