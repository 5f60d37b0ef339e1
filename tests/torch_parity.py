"""Shared helpers of the parity tests between the JAX package (``repro``)
and its PyTorch port (``repro_torch``): matched configs, seeded traces,
and the engine's equivalence contract (integer Stats identical, float
sums within 1e-3 relative, tests/test_engine.py)."""
import zlib

import numpy as np

from repro.core import address_separation as asep
from repro.core import controller as ctl
from repro_torch.core import address_separation as t_asep
from repro_torch.core import controller as t_ctl


def port_cfg(cfg: ctl.MorpheusConfig) -> t_ctl.MorpheusConfig:
    """The port's config equal to a reference config."""
    a = cfg.amap
    amap = t_asep.AddressMap(a.conv_sets, a.ext_sets, a.num_cache_chips,
                             a.sets_per_chip, a.vmem_sets_per_chip)
    return t_ctl.MorpheusConfig(
        amap=amap, conv_ways=cfg.conv_ways, ext_ways=cfg.ext_ways,
        compression=cfg.compression,
        predictor=t_ctl.Predictor(cfg.predictor.value),
        indirect_mov=cfg.indirect_mov)


def small_cfg(conv_sets=8, chips=2, sets_per_chip=4, **kw):
    """(reference, port) configs of a small cache with 4-way sets."""
    amap = asep.make_map(conv_sets=conv_sets, num_cache_chips=chips,
                         sets_per_chip=sets_per_chip)
    cfg = ctl.MorpheusConfig(amap=amap, conv_ways=4, ext_ways=4, **kw)
    return cfg, port_cfg(cfg)


def trace(n=600, span=2048, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, span, size=n).astype(np.uint32),
            rng.random(n) < 0.3,
            rng.integers(0, 3, size=n).astype(np.int32))


def case_seed(*parts) -> int:
    return zlib.crc32("/".join(map(str, parts)).encode()) % 1000


def leaf(stats, field, i=None) -> np.ndarray:
    x = getattr(stats, field)
    x = x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
    return x if i is None else x[i]


def assert_stats_equal(ref, port, ctx="", i=None):
    """Integer fields identical, float fields within 1e-3 relative."""
    for f in ctl.Stats._fields:
        a, b = leaf(ref, f, i), leaf(port, f, i)
        if f in ctl._INT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f"{ctx} {f}")
        else:
            tol = 1e-3 * np.maximum(np.abs(a.astype(np.float64)), 1.0)
            assert np.all(np.abs(a.astype(np.float64) - b) <= tol), \
                f"{ctx} {f}: reference={a} port={b}"
