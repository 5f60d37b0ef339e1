"""Serving in the PyTorch port (``repro.serving``): the two-tier page
pool (``paged_kv``), the engine that serves an LM through it
(``engine``) and its samplers (``sampler``)."""
from . import sampler
from .engine import PAGE_TOKENS, Engine, EngineReport, Request
from .paged_kv import (GatherPlan, MorpheusPagePool, PoolConfig,  # noqa: F401
                       PoolStats, TraceRecorder, page_key, pool_from_numpy,
                       pool_to_numpy)

__all__ = ["Engine", "EngineReport", "Request", "PAGE_TOKENS", "sampler",
           "GatherPlan", "MorpheusPagePool", "PoolConfig", "PoolStats",
           "TraceRecorder", "page_key", "pool_from_numpy", "pool_to_numpy"]
