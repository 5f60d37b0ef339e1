"""The serving page pool of the PyTorch port (``repro.serving``'s
``paged_kv``).  The reference's ``Engine``, ``Request`` and ``sampler``
wrap a full language model and come with the model substrates."""
from .paged_kv import (GatherPlan, MorpheusPagePool, PoolConfig,  # noqa: F401
                       PoolStats, TraceRecorder, page_key, pool_from_numpy,
                       pool_to_numpy)

__all__ = ["GatherPlan", "MorpheusPagePool", "PoolConfig", "PoolStats",
           "TraceRecorder", "page_key", "pool_from_numpy", "pool_to_numpy"]
