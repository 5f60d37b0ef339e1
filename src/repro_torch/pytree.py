"""Trees of the reference's shape, held as the port holds them.

The reference keeps its parameters, optimizer moments and compression
residuals in pytrees whose block leaves are stacked on axis 0 over the
``num_blocks`` repeats of the block pattern; the port keeps one tensor a
layer (``models.weights``).  A ``Leaf`` is one leaf of the reference's
tree in the port: its ``parts`` are the tensor itself, or the
``num_blocks`` per-layer tensors of a stacked leaf.  What the reference
decides per leaf is decided per ``Leaf`` here: AdamW's weight decay by
the reference leaf's rank (``ndim`` counts the stacking axis), the int8
compressor's scale over the whole stacked leaf, a checkpoint's leaf
paths, indices and shapes.

Trees are nested dicts, lists, tuples and NamedTuples whose leaves are
``Leaf``s, tensors, numpy arrays or numbers; ``None`` is a tree without
leaves.  ``flatten`` orders and names the leaves as
``jax.tree_util.tree_flatten_with_path`` does: dict keys sorted, a
NamedTuple field as ``.name``, a list index as its number, joined by
``/``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

Tree = Any


class Leaf:
    """One leaf of the reference's tree: ``parts`` (one tensor, or with
    ``stacked`` the per-block tensors that the reference stacks)."""
    __slots__ = ("parts", "stacked")

    def __init__(self, parts: Sequence[torch.Tensor], stacked: bool = False):
        self.parts = list(parts)
        self.stacked = stacked
        if not stacked and len(self.parts) != 1:
            raise ValueError("an unstacked leaf has one part")

    @property
    def ndim(self) -> int:
        """Rank of the reference's leaf (with the stacking axis)."""
        return self.parts[0].dim() + int(self.stacked)

    @property
    def shape(self) -> Tuple[int, ...]:
        inner = tuple(self.parts[0].shape)
        return (len(self.parts),) + inner if self.stacked else inner

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Leaf":
        return Leaf([fn(p) for p in self.parts], self.stacked)

    def numpy(self) -> np.ndarray:
        """The reference's array, fetched to the host (bfloat16 as its raw
        ``uint16`` bits, which numpy can hold)."""
        host = [to_numpy(p) for p in self.parts]
        return np.stack(host) if self.stacked else host[0]

    def load_(self, arr: np.ndarray) -> None:
        """Copy the reference's array ``arr`` into the parts, in place (a
        DTensor part: this rank's block of it into the local shard)."""
        for p, a in zip(self.parts, arr if self.stacked else [arr]):
            if isinstance(p, DTensor):
                a = a[_local_block(p)]
                p = p.to_local()
            p.copy_(from_numpy(a, p.dtype))


def _local_block(t: DTensor) -> Tuple[slice, ...]:
    """The index of this rank's block in the whole of ``t``."""
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return tuple(slice(o, o + n) for o, n in zip(offset, shape))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; bfloat16 as its raw ``uint16``
    bits.  A DTensor is gathered whole first (a collective: every rank of
    its mesh calls this)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_numpy(a: np.ndarray, dtype: torch.dtype,
               bits: str = "") -> torch.Tensor:
    """A host tensor of ``dtype`` from a numpy array; ``bits ==
    "bfloat16"`` reads ``uint16`` as bfloat16 bit patterns."""
    a = np.ascontiguousarray(a)
    if bits == "bfloat16" or (a.dtype == np.uint16
                              and dtype == torch.bfloat16):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(dtype)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree: Tree, prefix: Tuple[str, ...] = ()
            ) -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf, in the reference's order and names."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [x for f in tree._fields
                for x in flatten(getattr(tree, f), prefix + ("." + f,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flatten(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def leaves(tree: Tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``) in ``flatten``'s order, keeping the structure; ``None``
    stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def parts(tree: Tree) -> List[torch.Tensor]:
    """Every tensor of a tree of ``Leaf``s, in leaf order."""
    return [p for leaf in leaves(tree) for p in leaf.parts]


def from_parts(tree: Tree, flat: Sequence[torch.Tensor]) -> Tree:
    """A tree of ``tree``'s structure whose ``Leaf``s take their parts, in
    order, from ``flat`` (as ``parts`` lists them)."""
    it = iter(flat)
    return tree_map(lambda leaf: Leaf([next(it) for _ in leaf.parts],
                                      leaf.stacked), tree)
