"""Weights carried between the reference and the port.

The reference's parameter pytree (``repro.models.transformer.LM.init``)
is ``{"embed", ["unembed"], "final_norm", "prefix": [layer, ...],
"blocks": {"l0": layer, ...}}``, where each ``blocks`` leaf is stacked on
axis 0 over the ``num_blocks`` repeats of the block pattern (``jax.vmap``)
and a layer is ``{"ln1", "mixer": {...}, "ln2", "mlp": {...}}``.  The
port's ``LM`` keeps the same names per layer, in layer order, and the
reference's (in, out) weight layout, so no weight is transposed.

  * ``seeded_numpy_params(cfg, seed)`` builds such a tree with numpy
    alone, with the reference's distributions; the parity tests hand it
    to both packages, and it needs no JAX.
  * ``params_from_numpy(model, tree)`` loads a tree into the port (it
    unstacks the blocks); ``params_to_numpy(model)`` does the reverse.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig, LayerSpec
from . import attention as A
from . import layers as L


def has_mlp(cfg: ArchConfig, spec: LayerSpec) -> bool:
    return spec.mlp == "moe" or cfg.d_ff > 0


def layer_inits(cfg: ArchConfig, spec: LayerSpec) -> dict:
    """The ``layers.Init`` tree of one dense attention layer."""
    p = {"ln1": L.init_rms(cfg.d_model), "mixer": A.init_attn(cfg)}
    if has_mlp(cfg, spec):
        p["ln2"] = L.init_rms(cfg.d_model)
        p["mlp"] = L.init_dense_mlp(cfg.d_model, cfg.d_ff)
    return p


def top_inits(cfg: ArchConfig) -> dict:
    """The ``layers.Init`` tree of the parameters outside the layers."""
    return {**L.init_embed(cfg), "final_norm": L.init_rms(cfg.d_model)}


def layer_specs(cfg: ArchConfig) -> Tuple[LayerSpec, ...]:
    """Every layer's spec, in layer order (prefix, then the blocks)."""
    return cfg.prefix_layers + cfg.block_pattern * cfg.num_blocks


def leaves(tree: dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(dotted name, leaf) of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _map(tree: dict, fn: Callable) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _get(tree: dict, name: str):
    for part in name.split("."):
        tree = tree[part]
    return tree


def seeded_numpy_params(cfg: ArchConfig, seed: int = 0) -> dict:
    """The reference's parameter tree as float32 numpy arrays drawn from
    ``np.random.default_rng(seed)``: ``standard_normal * scale`` with the
    reference's scales, norms at one.  Leaves are drawn in tree order
    (top level, prefix layers, then each block-pattern entry with its
    ``num_blocks`` repeats stacked on axis 0)."""
    rng = np.random.default_rng(seed)

    def draw(init: L.Init, lead: Tuple[int, ...] = ()) -> np.ndarray:
        shape = lead + tuple(init.shape)
        if init.scale is None:
            return np.ones(shape, np.float32)
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(init.scale)
        return a

    tree = _map(top_inits(cfg), draw)
    tree["prefix"] = [_map(layer_inits(cfg, s), draw)
                      for s in cfg.prefix_layers]
    nb = cfg.num_blocks
    tree["blocks"] = {
        f"l{i}": _map(layer_inits(cfg, s), lambda x: draw(x, (nb,)))
        for i, s in enumerate(cfg.block_pattern)}
    return tree


def layer_source(cfg: ArchConfig, li: int) -> Tuple[str, int]:
    """Where layer ``li`` lives in the reference tree: ("prefix", i) or
    ("l<i>", block index)."""
    n_pre = len(cfg.prefix_layers)
    if li < n_pre:
        return "prefix", li
    j = li - n_pre
    pat = len(cfg.block_pattern)
    return f"l{j % pat}", j // pat


def _load(param: torch.Tensor, arr) -> None:
    a = np.asarray(arr)
    if tuple(a.shape) != tuple(param.shape):
        raise ValueError(f"shape {a.shape}, expected {tuple(param.shape)}")
    t = torch.from_numpy(np.ascontiguousarray(a))
    if param.device.type == "cpu" and t.dtype == param.dtype:
        param.data = t          # share the array's memory: no copy
    else:
        param.data.copy_(t)


def params_from_numpy(model, tree: dict) -> None:
    """Load the reference's parameter tree (numpy arrays) into ``model``
    (a ``models.LM``), unstacking ``tree["blocks"]``.  On the CPU, in the
    tree's dtype, the parameters share the arrays' memory."""
    cfg = model.cfg
    for name, _ in leaves(top_inits(cfg)):
        _load(getattr(model, name), tree[name])
    for li, layer in enumerate(model.layers):
        where, i = layer_source(cfg, li)
        src = tree["prefix"][i] if where == "prefix" else tree["blocks"][where]
        for name, _ in leaves(layer_inits(cfg, model.specs[li])):
            arr = _get(src, name)
            _load(layer.param(name), arr if where == "prefix" else arr[i])


def params_to_numpy(model) -> dict:
    """The reference's parameter tree (float32 numpy arrays, blocks
    stacked on axis 0) of ``model``'s weights."""
    cfg = model.cfg

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy().copy()

    tree: Dict[str, object] = {name: host(getattr(model, name))
                               for name, _ in leaves(top_inits(cfg))}
    n_pre = len(cfg.prefix_layers)
    tree["prefix"] = [
        _map_named(layer_inits(cfg, spec),
                   lambda n, li=li: host(model.layers[li].param(n)))
        for li, spec in enumerate(cfg.prefix_layers)]
    pat = len(cfg.block_pattern)
    tree["blocks"] = {
        f"l{i}": _map_named(
            layer_inits(cfg, spec),
            lambda n, i=i: np.stack([
                host(model.layers[n_pre + blk * pat + i].param(n))
                for blk in range(cfg.num_blocks)]))
        for i, spec in enumerate(cfg.block_pattern)}
    return tree


def _map_named(tree: dict, fn: Callable[[str], object],
               prefix: str = "") -> dict:
    return {k: (_map_named(v, fn, f"{prefix}{k}.") if isinstance(v, dict)
                else fn(prefix + k)) for k, v in tree.items()}
