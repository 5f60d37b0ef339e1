"""Parity of the port's system model and Table-3 policy with the
reference: ``run_batch`` RunResult fields within the engine's float bound
(integer Stats identical), and the same best split on a reduced grid."""
import dataclasses

import jax  # noqa: F401  (both packages in one process, data as numpy)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.core import cache_sim as j_cs  # noqa: E402
from repro.core import policy as j_policy  # noqa: E402
from repro_torch.core import cache_sim as t_cs  # noqa: E402
from repro_torch.core import policy as t_policy  # noqa: E402

FLOAT_FIELDS = ("exec_time_s", "ipc", "perf_per_watt", "llc_hit_rate",
                "mpki", "dram_GBps", "noc_GBps", "llc_throughput_GBps",
                "energy_J")

POINTS = [
    ("kmeans", "BL", 18, 0, 2000, 0, ()),
    ("cfd", "Morpheus-ALL", 32, 24, 2000, 1, ()),
    ("histo", "Unified-SM-Mem", 32, 0, 2000, 0, ()),
    ("spmv", "Morpheus-Basic", 24, 24, 2000, 0,
     (("compression", True), ("predictor", "perfect"))),
    ("lib", "Morpheus-Compression", 24, 44, 1000, 0, ()),
]


def test_run_batch_matches_reference():
    ref = j_cs.run_batch([j_cs.RunPoint(a, s, nc, nk, n, seed, "jnp", ov)
                          for a, s, nc, nk, n, seed, ov in POINTS])
    got = t_cs.run_batch([t_cs.RunPoint(a, s, nc, nk, n, seed, ov)
                          for a, s, nc, nk, n, seed, ov in POINTS],
                         device="cpu")
    for r, g in zip(ref, got):
        ctx = f"{r.app}/{r.system}/{r.n_compute}"
        assert (r.app, r.system, r.n_compute, r.n_cache) == \
            (g.app, g.system, g.n_compute, g.n_cache), ctx
        tp.assert_stats_equal(r.stats, g.stats, ctx)
        assert r.llc_accesses == g.llc_accesses, ctx
        for f in FLOAT_FIELDS:
            a, b = getattr(r, f), getattr(g, f)
            assert abs(a - b) <= 1e-3 * max(abs(a), 1e-30), (ctx, f, a, b)


def test_configs_and_overrides_match_reference():
    for name in j_cs.SYSTEMS:
        for n_cache in (0, 8, 51):
            ref = j_cs.build_config(j_cs.SYSTEMS[name], n_cache)
            got = t_cs.build_config(t_cs.SYSTEMS[name], n_cache)
            assert tp.port_cfg(ref) == got, (name, n_cache)
            assert dataclasses.asdict(ref.amap) == dataclasses.asdict(got.amap)
    ov = (("ext_ways", "16"), ("indirect_mov", 1), ("predictor", "none"))
    base = j_cs.build_config(j_cs.SYSTEMS["Morpheus-Basic"], 8)
    assert tp.port_cfg(j_cs.apply_overrides(base, ov)) == \
        t_cs.apply_overrides(tp.port_cfg(base), ov)
    with pytest.raises(ValueError):
        t_cs.apply_overrides(tp.port_cfg(base), (("bogus", 1),))


@pytest.mark.parametrize("app,system", [("kmeans", "Morpheus-ALL"),
                                        ("cfd", "IBL")])
def test_best_split_matches_reference(app, system):
    grid = (24, 48)
    ref = j_policy.best_split(app, system, grid=grid, length=1500,
                              backend="jnp")
    got = t_policy.best_split(app, system, grid=grid, length=1500,
                              device="cpu")
    assert (ref.n_compute, ref.n_cache) == (got.n_compute, got.n_cache)
    assert np.isclose(ref.exec_time_s, got.exec_time_s, rtol=1e-3)


def test_table3_grid_matches_reference():
    ref = j_policy.grid_points("kmeans", "Morpheus-ALL",
                               grid=j_policy.DEFAULT_GRID, length=100)
    got = t_policy.grid_points("kmeans", "Morpheus-ALL",
                               grid=t_policy.DEFAULT_GRID, length=100)
    assert [(p.n_compute, p.n_cache) for p in ref] == \
        [(p.n_compute, p.n_cache) for p in got]
    out = t_policy.table3(("IBL",), ("cfd",), length=1500, device="cpu")
    want = j_policy.table3(("IBL",), ("cfd",), length=1500, backend="jnp")
    assert out["IBL"]["cfd"].n_compute == want["IBL"]["cfd"].n_compute
