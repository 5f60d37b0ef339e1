"""Weights carried between the reference and the port.

The reference's parameter pytree (``repro.models.transformer.LM.init``)
is ``{"embed", ["unembed"], "final_norm", "prefix": [layer, ...],
"blocks": {"l0": layer, ...}, ["encoder": {"layers": [layer, ...],
"final_norm"}]}``, where each ``blocks`` leaf is stacked on axis 0 over
the ``num_blocks`` repeats of the block pattern (``jax.vmap``) and a layer
is ``{"ln1", "mixer": {...}, "ln2", "mlp": {...}}``, with ``"ln_x",
"xattn": {...}`` on the block layers of an encoder-decoder arch.  A mixer
is an attention's (GQA or MLA) or a Mamba2's; an MLP is dense or MoE
(experts stacked (E, D, F), the shared experts as ``"shared"``).  The
port's ``LM`` keeps the same names per layer, in layer order, and the
reference's (in, out) weight layout, so no weight is transposed.

  * ``seeded_numpy_params(cfg, seed)`` builds such a tree with numpy
    alone, with the reference's distributions; the parity tests hand it
    to both packages, and it needs no JAX.
  * ``params_from_numpy(model, tree)`` loads a tree into the port (it
    unstacks the blocks); ``params_to_numpy(model)`` does the reverse.
  * ``param_tree(model)`` is the reference's tree over the model's own
    parameters, each block leaf a ``pytree.Leaf`` of its per-layer
    parts: what the optimizer, the gradient compressor and the
    checkpointer walk.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig, LayerSpec
from ..pytree import Leaf
from . import attention as A
from . import layers as L
from . import mamba2 as M
from . import moe as MoE


def has_mlp(cfg: ArchConfig, spec: LayerSpec) -> bool:
    return spec.mlp == "moe" or cfg.d_ff > 0


def layer_inits(cfg: ArchConfig, spec: LayerSpec, *,
                cross: bool = False) -> dict:
    """The ``layers.Init`` tree of one layer: its mixer, its MLP (if any)
    and, with ``cross``, its cross-attention block."""
    d = cfg.d_model
    p = {"ln1": L.init_rms(d),
         "mixer": (M.init_mamba(cfg) if spec.mixer == "mamba"
                   else A.init_attn(cfg))}
    if has_mlp(cfg, spec):
        p["ln2"] = L.init_rms(d)
        p["mlp"] = (MoE.init_moe(cfg) if spec.mlp == "moe"
                    else L.init_dense_mlp(d, cfg.d_ff))
    if cross:
        p["ln_x"] = L.init_rms(d)
        p["xattn"] = A.init_attn(cfg, cross=True)
    return p


def has_cross(cfg: ArchConfig, li: int) -> bool:
    """Whether decoder layer ``li`` has a cross-attention block: the block
    layers of an encoder-decoder arch do, its prefix layers do not."""
    return cfg.is_encdec and li >= len(cfg.prefix_layers)


def top_inits(cfg: ArchConfig) -> dict:
    """The ``layers.Init`` tree of the parameters outside the layers."""
    return {**L.init_embed(cfg), "final_norm": L.init_rms(cfg.d_model)}


ENCODER_SPEC = LayerSpec()


def encoder_inits(cfg: ArchConfig) -> dict:
    """The ``layers.Init`` tree of one encoder layer (global attention and
    a dense MLP, no cross block)."""
    return layer_inits(cfg, ENCODER_SPEC)


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
    reference's scales, norms at one, zeros drawn from nothing.  Leaves
    are drawn in tree order (top level, prefix layers, each
    block-pattern entry with its ``num_blocks`` repeats stacked on axis 0,
    then the encoder's layers and its final norm)."""
    rng = np.random.default_rng(seed)

    def draw(init: L.Init, lead: Tuple[int, ...] = ()) -> np.ndarray:
        shape = lead + tuple(init.shape)
        if init.scale is None:
            return np.ones(shape, np.float32)
        if init.scale == 0:
            return np.zeros(shape, np.float32)
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(init.scale)
        return a

    tree = _map(top_inits(cfg), draw)
    tree["prefix"] = [_map(layer_inits(cfg, s), draw)
                      for s in cfg.prefix_layers]
    nb = cfg.num_blocks
    tree["blocks"] = {
        f"l{i}": _map(layer_inits(cfg, s, cross=cfg.is_encdec),
                      lambda x: draw(x, (nb,)))
        for i, s in enumerate(cfg.block_pattern)}
    if cfg.is_encdec:
        tree["encoder"] = {
            "layers": [_map(encoder_inits(cfg), draw)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": draw(L.init_rms(cfg.d_model))}
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


def _sources(model, tree: dict) -> Iterator[Tuple[torch.Tensor, object]]:
    """(parameter of ``model``, its array in the reference's ``tree``)
    of every parameter, a block leaf's array unstacked."""
    cfg = model.cfg
    for name, _ in leaves(top_inits(cfg)):
        yield getattr(model, name), tree[name]
    for li, layer in enumerate(model.layers):
        where, i = layer_source(cfg, li)
        src = tree["prefix"][i] if where == "prefix" else tree["blocks"][where]
        for name, _ in leaves(layer_inits(cfg, model.specs[li],
                                          cross=has_cross(cfg, li))):
            arr = _get(src, name)
            yield layer.param(name), arr if where == "prefix" else arr[i]
    if cfg.is_encdec:
        enc = tree["encoder"]
        for layer, src in zip(model.encoder_layers, enc["layers"]):
            for name, _ in leaves(encoder_inits(cfg)):
                yield layer.param(name), _get(src, name)
        yield model.encoder_norm, enc["final_norm"]


def numpy_sources(model, tree: dict) -> Dict[int, object]:
    """{id(parameter): its array} of the reference's ``tree`` (views; the
    tensor-parallel build cuts each into this rank's shard)."""
    return {id(p): arr for p, arr in _sources(model, tree)}


def params_from_numpy(model, tree: dict) -> None:
    """Load the reference's parameter tree (numpy arrays) into ``model``
    (a ``models.LM``), unstacking ``tree["blocks"]``.  On the CPU, in the
    tree's dtype, the parameters share the arrays' memory."""
    for param, arr in _sources(model, tree):
        _load(param, arr)


def param_tree(model) -> dict:
    """The reference's parameter tree of ``model`` with ``Leaf`` leaves
    over the model's own parameters (a block leaf's parts in block
    order)."""
    return _tree_of(model, lambda t: Leaf([t]),
                    lambda ts: Leaf(ts, stacked=True))


def params_to_numpy(model) -> dict:
    """The reference's parameter tree (float32 numpy arrays, blocks
    stacked on axis 0) of ``model``'s weights."""
    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy().copy()

    return _tree_of(model, host, lambda ts: np.stack([host(t) for t in ts]))


def _tree_of(model, one: Callable, stack: Callable) -> dict:
    """The reference's tree of ``model``'s parameters: ``one(t)`` of an
    unstacked parameter, ``stack(ts)`` of a block leaf's per-layer
    parameters."""
    cfg = model.cfg
    tree: Dict[str, object] = {name: one(getattr(model, name))
                               for name, _ in leaves(top_inits(cfg))}
    n_pre = len(cfg.prefix_layers)
    tree["prefix"] = [
        _map_named(layer_inits(cfg, spec),
                   lambda n, li=li: one(model.layers[li].param(n)))
        for li, spec in enumerate(cfg.prefix_layers)]
    pat = len(cfg.block_pattern)
    tree["blocks"] = {
        f"l{i}": _map_named(
            layer_inits(cfg, spec, cross=cfg.is_encdec),
            lambda n, i=i: stack([
                model.layers[n_pre + blk * pat + i].param(n)
                for blk in range(cfg.num_blocks)]))
        for i, spec in enumerate(cfg.block_pattern)}
    if cfg.is_encdec:
        tree["encoder"] = {
            "layers": [_map_named(encoder_inits(cfg),
                                  lambda n, layer=layer: one(layer.param(n)))
                       for layer in model.encoder_layers],
            "final_norm": one(model.encoder_norm)}
    return tree


def _map_named(tree: dict, fn: Callable[[str], object],
               prefix: str = "") -> dict:
    return {k: (_map_named(v, fn, f"{prefix}{k}.") if isinstance(v, dict)
                else fn(prefix + k)) for k, v in tree.items()}
