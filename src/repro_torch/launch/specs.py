"""Shapes-only stand-ins for every model input, after
``repro.launch.specs``: ``meta`` tensors in place of the reference's
``jax.ShapeDtypeStruct``s, so a cell is counted at full width without
allocating anything (``launch.dryrun``).

``input_specs(cfg, shape)`` returns the batch for the shape's kind;
``abstract_params``/``abstract_caches`` give a model's state, built on
``meta``.  Modality frontends are stubs exactly as in the reference:
[audio] archs get precomputed frame embeddings, [vlm] archs get
precomputed patch embeddings plus M-RoPE position streams.  Nothing on
``meta`` holds data: these are shapes to count, never results.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from ..configs.shapes import ShapeConfig
from ..models import layers as L
from ..models.transformer import LM, Caches
from ..models.weights import param_tree

ENC_FRAMES = 1024       # audio stub: encoder frame count
VLM_PATCHES = 256       # vision stub: patch prefix length
META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        batch: Dict[str, Any] = {"tokens": sds((b, s), i32)}
        if shape.kind == "train":
            batch["targets"] = sds((b, s), i32)
        if cfg.is_encdec:
            batch["frame_embeds"] = sds((b, ENC_FRAMES, cfg.d_model),
                                        torch.float32)
        if cfg.family == "vlm":
            batch["patch_embeds"] = sds((b, VLM_PATCHES, cfg.d_model),
                                        torch.float32)
        if cfg.mrope_sections is not None:
            batch["positions"] = sds((3, b, s), i32)
        return batch
    # decode: one new token against a seq_len-sized cache
    return {"tokens": sds((b,), i32), "cur_pos": sds((), i32)}


def abstract_params(model: LM):
    """The reference's parameter tree of a ``meta`` model: ``pytree.Leaf``
    leaves over its parameters (a block leaf's ``shape`` the reference's
    stacked one)."""
    return param_tree(model)


def abstract_caches(model: LM, shape: ShapeConfig) -> Caches:
    """The caches of a ``meta`` model for ``shape``: one per layer in the
    model's dtype (the reference's dry run measures caches in the model
    dtype too), and ``enc_out`` (B, ENC_FRAMES, D) for an
    encoder-decoder arch."""
    b, s = shape.global_batch, shape.seq_len
    caches = model.init_caches(b, s)
    if model.cfg.is_encdec:
        caches.enc_out = sds((b, ENC_FRAMES, model.cfg.d_model),
                             L.dtype_of(model.cfg))
    return caches
