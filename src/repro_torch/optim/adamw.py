"""AdamW with decoupled weight decay and global-norm clipping, after
``repro.optim.adamw``.

The trees are the reference's, with ``pytree.Leaf`` leaves (the
parameters are the model's own ``nn.Parameter``s).  ``update`` writes
the parameters and moments in place, under ``torch.no_grad``, in float32
as the reference computes them, and returns the same trees.  Weight
decay applies where the REFERENCE leaf has rank >= 2: its block leaves
are stacked over the blocks, so a block layer's norm (``ln1``,
``q_norm``, ``A_log`` ...) is decayed there while ``final_norm`` and the
prefix layers' norms are not; ``Leaf.ndim`` counts the stacking axis, so
the port decays the same leaves.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..pytree import Leaf, leaves, tree_map

Tree = Any


class AdamWState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@dataclass(frozen=True)
class AdamW:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: torch.dtype = torch.float32
    schedule: Optional[Any] = None    # callable step -> lr scale

    def init(self, params: Tree) -> AdamWState:
        z = lambda leaf: leaf.map(
            lambda p: torch.zeros(p.shape, dtype=self.moment_dtype,
                                  device=p.device))
        return AdamWState(step=0, mu=tree_map(z, params),
                          nu=tree_map(z, params))

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState, params: Tree
               ) -> Tuple[Tree, AdamWState]:
        step = state.step + 1
        g_leaves = leaves(grads)
        if self.clip_norm:
            gn = global_norm(grads)
            scale = torch.clamp(self.clip_norm / (gn + 1e-9), max=1.0)
            g_leaves = [g.map(lambda x: x * scale.to(x.dtype))
                        for g in g_leaves]
        b1, b2 = self.b1, self.b2
        step32 = _f32(step)
        c1 = float(1 - _f32(b1) ** step32)
        c2 = float(1 - _f32(b2) ** step32)
        lr = _f32(self.learning_rate)
        if self.schedule is not None:
            lr = lr * self.schedule(step)
        lr = float(lr)
        decay = self.weight_decay
        for p_leaf, m_leaf, v_leaf, g_leaf in zip(
                leaves(params), leaves(state.mu), leaves(state.nu),
                g_leaves):
            decayed = bool(decay) and p_leaf.ndim >= 2
            for p, m, v, g in zip(p_leaf.parts, m_leaf.parts, v_leaf.parts,
                                  g_leaf.parts):
                g32 = g.float()
                m32 = b1 * m.float() + (1 - b1) * g32
                v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
                m.copy_(m32)
                v.copy_(v32)
                m32, v32 = m.float(), v.float()   # through moment_dtype
                u = (m32 / c1) / (torch.sqrt(v32 / c2) + self.eps)
                if decayed:
                    u = u + decay * p.float()
                p.copy_(p.float() - lr * u)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a 0-d
    tensor on the leaves' device)."""
    total = None
    for leaf in leaves(tree):
        parts = leaf.parts if isinstance(leaf, Leaf) else [leaf]
        for x in parts:
            s = torch.sum(torch.square(x.float()))
            total = s if total is None else total + s
    return torch.sqrt(total)
