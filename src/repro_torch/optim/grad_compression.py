"""int8 gradient compression with error feedback, after
``repro.optim.grad_compression``.

The scale is one per REFERENCE leaf: ``max|g| / 127`` over the whole
leaf, which for a block leaf is stacked over the blocks, so the port
takes the max over all of a ``pytree.Leaf``'s parts.  Both packages
round half to even, so the int8 codes are the reference's bit for bit.
On one card there is no all-reduce to shrink; ``roundtrip`` (quantize,
dequantize, keep the residual) is what the train step runs, as in the
reference.  Torch ops: an elementwise pass and one ``amax`` a part (the
reference has no kernel here).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, NamedTuple, Sequence, Tuple, Union

import torch

from ..pytree import Leaf, tree_map

Tree = Any


class CompressorState(NamedTuple):
    residual: Tree


def _parts(g) -> List[torch.Tensor]:
    if isinstance(g, Leaf):
        return g.parts
    return [g] if isinstance(g, torch.Tensor) else list(g)


@dataclass(frozen=True)
class Int8Compressor:
    enabled: bool = True

    def init(self, params: Tree) -> CompressorState:
        return CompressorState(residual=tree_map(
            lambda leaf: leaf.map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device)), params))

    def quantize(self, g: Union[torch.Tensor, Leaf, Sequence[torch.Tensor]]
                 ) -> Tuple[Any, torch.Tensor]:
        """(int8 codes, f32 scale) of a tensor, or of a leaf's parts with
        one scale over them all (the codes then a list)."""
        ps = _parts(g)
        amax = ps[0].abs().amax()
        for p in ps[1:]:
            amax = torch.maximum(amax, p.abs().amax())
        scale = amax / 127.0 + 1e-12
        q = [torch.clamp(torch.round(p / scale), -127, 127).to(torch.int8)
             for p in ps]
        return (q[0] if isinstance(g, torch.Tensor) else q), scale

    def dequantize(self, q, scale: torch.Tensor):
        if isinstance(q, torch.Tensor):
            return q.float() * scale
        return [x.float() * scale for x in q]

    @torch.no_grad()
    def roundtrip(self, grads: Tree, state: CompressorState
                  ) -> Tuple[Tree, CompressorState]:
        if not self.enabled:
            return grads, state

        def one(g: Leaf, r: Leaf) -> Leaf:
            g32 = [x.float() + y for x, y in zip(g.parts, r.parts)]
            q, s = self.quantize(g32)
            deq = self.dequantize(q, s)
            for y, a, b in zip(r.parts, g32, deq):
                y.copy_(a - b)
            return Leaf([d.to(x.dtype) for d, x in zip(deq, g.parts)],
                        g.stacked)

        return tree_map(one, grads, state.residual), state
