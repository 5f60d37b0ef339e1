"""The program under test, built from a configuration file: the
repository's ``repro_torch`` config of that name with the file's sizes
and its layer layout's keys (``layouts/``), its ``LM`` on the device,
and the benchmark's seeded weights copied into it.  Only the runner
imports this module."""
from __future__ import annotations

from dataclasses import fields, replace

import torch

import layouts

from . import weights as W

# the configuration file's keys that are fields of the program's config
SIZE_KEYS = ("d_model", "num_layers", "num_heads", "num_kv_heads",
             "head_dim", "d_ff", "vocab_size", "rope_theta", "num_experts",
             "top_k", "num_shared_experts", "moe_d_ff", "capacity_factor",
             "tie_embeddings", "act")


def arch_of(cfg: dict):
    """The program's ``ArchConfig`` for configuration ``cfg``: the file's
    sizes, then its layout's ``ARCH_KEYS`` (each required), then the
    layout's ``ARCH_FIXED``."""
    from repro_torch import configs
    layout = layouts.of(cfg)
    base = configs.get(cfg["repo_config"])
    kw = {k: cfg[k] for k in SIZE_KEYS if k in cfg}
    if "mrope_sections" in cfg:
        kw["mrope_sections"] = tuple(cfg["mrope_sections"])
    kw["param_dtype"] = cfg["dtype"]
    missing = [k for k in layout.ARCH_KEYS if k not in cfg]
    if missing:
        raise ValueError(f"{cfg['name']}: its layout needs {missing}")
    kw.update({k: cfg[k] for k in layout.ARCH_KEYS})
    kw.update(layout.ARCH_FIXED)
    unknown = sorted(set(kw) - {f.name for f in fields(base)})
    if unknown:
        raise ValueError(f"{cfg['name']}: {unknown} are not fields of the "
                         f"program's ArchConfig")
    arch = replace(base, **kw)
    if cfg.get("num_experts", 0) and len(arch.prefix_layers) != cfg.get(
            "first_dense_layers", 0):
        raise ValueError(f"{cfg['name']}: the program's config has "
                         f"{len(arch.prefix_layers)} leading dense layers")
    return arch


def build_model(cfg: dict, seed: int, device: torch.device):
    """The program's ``LM`` of ``cfg`` on ``device`` with the seeded
    weights."""
    from repro_torch.models.transformer import LM
    return load_weights(LM(arch_of(cfg), device=device), cfg, seed)


@torch.no_grad()
def load_weights(model, cfg: dict, seed: int):
    """Copy the weights of ``seed`` into ``model``, drawn a layer at a
    time on its device."""
    dev = model.device
    for name, t in W.draw_top(cfg, seed, dev).items():
        getattr(model, name).copy_(t)
    for li, layer in enumerate(model.layers):
        for name, t in W.draw_layer(cfg, seed, li, dev).items():
            layer.param(name).copy_(t)
    return model


def leaf_params(model) -> dict:
    """The model's parameters under the reference's names."""
    out = {}
    for name in ("embed", "unembed", "final_norm"):
        p = getattr(model, name, None)
        if p is not None:
            out[name] = p
    for li, layer in enumerate(model.layers):
        for name, p in layer.named_parameters():
            out[f"layers.{li}.{name}"] = p
    return out
