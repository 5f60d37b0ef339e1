"""Shared helpers of the parity tests between the JAX package (``repro``)
and its PyTorch port (``repro_torch``): matched configs, seeded traces,
and the engine's equivalence contract (integer Stats identical, float
sums within 1e-3 relative, tests/test_engine.py)."""
import zlib

import numpy as np
import pytest
import torch

from repro.core import address_separation as asep
from repro.core import controller as ctl
from repro_torch.core import address_separation as t_asep
from repro_torch.core import controller as t_ctl


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's tests with one torch intra-op thread (a test module
    opts in by importing this fixture).  The plain versions step many
    small tensors, and test-runner workers that each keep a full thread
    pool oversubscribe the host: the CPU ``simulate_online`` of
    tests/test_torch_obs.py took 454 s in each of six concurrent
    processes at 8 threads, and 1 s at one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def pool_payload(key: int, words: int = 32) -> np.ndarray:
    """The page payload of ``key`` that the pool tests and the golden
    pool file install (``chip_smoke.py`` repeats the rule): a block that
    BDI compresses to HIGH, LOW or UNCOMP (``key % 3``) around a
    key-derived base, wrapping mod 2^32."""
    i = np.arange(words, dtype=np.int64)
    base = (int(key) * 0x9E3779B1) & 0xFFFFFFFF
    step = (1, 1000, 0x01000193)[int(key) % 3]
    return ((base + (i - words // 2) * step) % (1 << 32)).astype(np.uint32)


def pool_stream(total_sets: int, conv_sets: int, n_batches=3, seed=0,
                size=32):
    """Batches of page keys for a pool with these sets: random keys over
    a span a few times the sets, repeats of earlier keys, a duplicate
    within the batch, a tag-0 key (below ``total_sets``) and six keys of
    one conventional set (more than the 4 rounds a batch serves)."""
    rng = np.random.default_rng(seed)
    seen = []
    for _ in range(n_batches):
        keys = list(rng.integers(total_sets, 5 * total_sets, size=size - 10))
        if seen:
            keys += list(rng.choice(seen, size=2))
        keys += [keys[0], int(rng.integers(0, total_sets))]
        s = int(rng.integers(0, conv_sets))
        keys += [s + j * total_sets for j in range(1, 7)]
        keys = np.asarray(keys, np.uint32)
        seen += list(keys)
        yield keys
