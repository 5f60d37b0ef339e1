"""Assigned-architecture registry: ``get(name)`` / ``ALL_ARCHS``.

A copy of the reference's ``repro.configs`` (pure Python, no JAX), held
equal to it by ``tests/test_torch_models.py``.  The registry lists every
architecture; ``models.LM`` refuses the ones the port cannot run yet."""
from __future__ import annotations

from typing import Dict

from .base import ArchConfig, LayerSpec, GLOBAL, LOCAL, MAMBA
from .shapes import SHAPES, ShapeConfig

from .seamless_m4t_medium import CONFIG as _seamless
from .h2o_danube_1_8b import CONFIG as _danube
from .gemma2_9b import CONFIG as _gemma2
from .gemma3_27b import CONFIG as _gemma3
from .qwen3_4b import CONFIG as _qwen3
from .qwen2_vl_7b import CONFIG as _qwen2vl
from .jamba_1_5_large import CONFIG as _jamba
from .deepseek_v2_lite import CONFIG as _dsv2lite
from .deepseek_moe_16b import CONFIG as _dsmoe
from .mamba2_780m import CONFIG as _mamba2

ALL_ARCHS: Dict[str, ArchConfig] = {c.name: c for c in [
    _seamless, _danube, _gemma2, _gemma3, _qwen3, _qwen2vl, _jamba,
    _dsv2lite, _dsmoe, _mamba2,
]}


def get(name: str) -> ArchConfig:
    if name not in ALL_ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ALL_ARCHS)}")
    return ALL_ARCHS[name]


def cells(include_skipped: bool = False):
    """All assigned (arch x shape) dry-run cells.  ``long_500k`` is skipped
    for pure full-attention archs (see DESIGN.md §long_500k skip notes)."""
    out = []
    for aname, cfg in ALL_ARCHS.items():
        for sname, shape in SHAPES.items():
            skipped = (sname == "long_500k" and not cfg.supports_long_context)
            if skipped and not include_skipped:
                continue
            out.append((aname, sname, skipped))
    return out


__all__ = ["ArchConfig", "LayerSpec", "GLOBAL", "LOCAL", "MAMBA",
           "SHAPES", "ShapeConfig", "ALL_ARCHS", "get", "cells"]
