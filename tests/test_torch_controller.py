"""Parity of the port's controller (``repro_torch.core.controller``) with
the reference: single steps of the per-set transition kernels on random
rows (LRU ties, all-invalid rows, full rows), and the serial oracle over
the predictor x compression grid of tests/test_engine.py."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.core import controller as ctl  # noqa: E402
from repro_torch.core import controller as t_ctl  # noqa: E402

ROW_KINDS = ("random", "ties", "empty", "full")


def _rows(kind: str, ways: int, rng, tag_pool):
    """(tags, valid, dirty, lru, size) of one set for a row kind."""
    tags = rng.choice(tag_pool, size=ways).astype(np.uint32)
    dirty = rng.random(ways) < 0.5
    if kind == "empty":
        valid = np.zeros(ways, bool)
    elif kind == "full":
        valid = np.ones(ways, bool)
    else:
        valid = rng.random(ways) < 0.7
    if kind == "ties":
        lru = rng.choice([0, 0xFFE], size=ways).astype(np.uint32)
    else:
        lru = rng.integers(0, 0x1000, size=ways).astype(np.uint32)
    size = rng.choice([32, 64, 128], size=ways).astype(np.int32) * valid
    return tags, valid, dirty, lru, size


def _t(a):
    a = np.array(a)          # keeps 0-d arrays 0-d
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _same(ref, got, ctx):
    for name, r, g in zip(ref._fields, ref, got):
        r = np.asarray(r)
        g = g.numpy()
        if r.dtype == np.uint32:
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, r, err_msg=f"{ctx} {name}")


@pytest.mark.parametrize("kind", ROW_KINDS)
def test_conv_set_kernel_single_steps(kind):
    cfg, pcfg = tp.small_cfg()
    rng = np.random.default_rng(tp.case_seed("conv", kind))
    pool = np.array([0, 7, 2 ** 31, 2 ** 32 - 1, 12345], np.uint32)
    for trial in range(8):
        tags, valid, dirty, lru, _ = _rows(kind, 4, rng, pool)
        tag = np.uint32(rng.choice(pool))
        wr = bool(rng.random() < 0.5)
        row = ctl.ConvRow(jnp.asarray(tags), jnp.asarray(valid),
                          jnp.asarray(dirty), jnp.asarray(lru))
        ref_row, ref_out = ctl.conv_set_kernel(cfg, row, jnp.uint32(tag), wr)
        prow = t_ctl.ConvRow(_t(tags), _t(valid), _t(dirty), _t(lru))
        got_row, got_out = t_ctl.conv_set_kernel(
            pcfg, prow, _t(np.array(tag)), torch.tensor(wr))
        _same(ref_row, got_row, f"{kind}/{trial}")
        _same(ref_out, got_out, f"{kind}/{trial}")


@pytest.mark.parametrize("kind,pred,comp", list(itertools.product(
    ROW_KINDS, list(ctl.Predictor), [False, True])))
def test_ext_set_kernel_single_steps(kind, pred, comp):
    cfg, pcfg = tp.small_cfg(predictor=pred, compression=comp)
    ways = cfg.ext_max_ways
    rng = np.random.default_rng(tp.case_seed("ext", kind, pred.value, comp))
    pool = np.array([0, 3, 2 ** 31, 2 ** 32 - 1, 999], np.uint32)
    for trial in range(3):
        tags, valid, dirty, lru, size = _rows(kind, ways, rng, pool)
        used = np.int32(min(int(size.sum()), cfg.ext_budget_bytes))
        bf1 = rng.integers(0, 2 ** 32, size=8, dtype=np.uint32)
        bf2 = rng.integers(0, 2 ** 32, size=8, dtype=np.uint32) & bf1
        n_mru = np.int32(rng.integers(0, cfg.ext_ways))
        tag = np.uint32(rng.choice(pool))
        wr = bool(rng.random() < 0.5)
        level = np.int32(rng.integers(0, 3))
        row = ctl.ExtRow(*[jnp.asarray(x) for x in
                           (tags, valid, dirty, lru, size, used, bf1, bf2,
                            n_mru)])
        ref_row, ref_out = ctl.ext_set_kernel(cfg, row, jnp.uint32(tag), wr,
                                              jnp.int32(level))
        prow = t_ctl.ExtRow(*[_t(x) for x in
                              (tags, valid, dirty, lru, size, used, bf1, bf2,
                               n_mru)])
        got_row, got_out = t_ctl.ext_set_kernel(
            pcfg, prow, _t(np.array(tag)), torch.tensor(wr),
            _t(np.array(level)))
        ctx = f"{kind}/{pred.value}/{comp}/{trial}"
        _same(ref_row, got_row, ctx)
        _same(ref_out, got_out, ctx)


@pytest.mark.parametrize("pred,comp", list(itertools.product(
    list(ctl.Predictor), [False, True])))
def test_serial_simulate_matches_reference(pred, comp):
    cfg, pcfg = tp.small_cfg(predictor=pred, compression=comp)
    addrs, writes, levels = tp.trace(n=300,
                                     seed=tp.case_seed(pred.value, comp))
    warmup = 57
    ref = ctl.simulate(cfg, jnp.asarray(addrs), jnp.asarray(writes),
                       jnp.asarray(levels), warmup)
    got = t_ctl.simulate(pcfg, addrs, writes, levels, warmup, device="cpu")
    tp.assert_stats_equal(ref, got, f"serial/{pred.value}/comp={comp}")


def test_address_separation_matches_reference():
    from repro.core import address_separation as j_asep
    from repro_torch.core import address_separation as t_asep
    rng = np.random.default_rng(4)
    addrs = np.concatenate([np.array([0, 2 ** 31, 2 ** 32 - 1], np.uint32),
                            rng.integers(0, 2 ** 32, size=300,
                                         dtype=np.uint32)])
    for conv_sets, chips, per_chip in ((160, 36, 10), (16, 0, 10), (8, 2, 4)):
        jm = j_asep.make_map(conv_sets=conv_sets, num_cache_chips=chips,
                             sets_per_chip=per_chip)
        tm = t_asep.make_map(conv_sets=conv_sets, num_cache_chips=chips,
                             sets_per_chip=per_chip)
        assert (jm.conv_sets, jm.ext_sets, jm.vmem_sets_per_chip,
                jm.total_sets) == (tm.conv_sets, tm.ext_sets,
                                   tm.vmem_sets_per_chip, tm.total_sets)
        a = torch.from_numpy(addrs.view(np.int32))
        ja = jnp.asarray(addrs)
        np.testing.assert_array_equal(t_asep.set_index(tm, a).numpy(),
                                      np.asarray(j_asep.set_index(jm, ja)))
        np.testing.assert_array_equal(t_asep.tag_of(tm, a).numpy(),
                                      np.asarray(j_asep.tag_of(jm, ja)))
        for r, g in zip(j_asep.route(jm, ja), t_asep.route(tm, a)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        ext = np.arange(max(jm.ext_sets, 1), dtype=np.int32)
        np.testing.assert_array_equal(
            t_asep.owner_of(tm, torch.from_numpy(ext)).numpy(),
            np.asarray(j_asep.owner_of(jm, jnp.asarray(ext))))
        np.testing.assert_array_equal(
            t_asep.unit_of(tm, torch.from_numpy(ext)).numpy(),
            np.asarray(j_asep.unit_of(jm, jnp.asarray(ext))))
        assert t_asep.capacity_bytes(tm, 32, 128) == \
            j_asep.capacity_bytes(jm, 32, 128)
    with pytest.raises(ValueError):
        t_asep.AddressMap(8, 5, 2, 4, 1)
