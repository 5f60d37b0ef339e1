"""The port's numpy pieces are byte-identical to the reference: the
Table-2 trace generators (golden crc of tests/test_workloads.py) and the
engine's ``pack``, including the edge cases of tests/test_engine.py."""
import zlib

import jax  # noqa: F401  (both packages in one process, data as numpy)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401
from repro.core import engine as j_engine  # noqa: E402
from repro.workloads import synthetic as j_syn  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import traces as t_traces  # noqa: E402
from repro_torch.workloads import synthetic as t_syn  # noqa: E402


def test_synthetic_golden_crc():
    a, w, l = t_syn.generate("cfd", n_cores=8, length=4000, seed=3,
                             ws_scale=0.125)
    assert (zlib.crc32(a.tobytes()), zlib.crc32(w.tobytes()),
            zlib.crc32(l.tobytes())) == (1118088029, 821650521, 862733448)


@pytest.mark.parametrize("app", ["cfd", "kmeans", "histo", "mri-gri",
                                 "stencil", "dwt2d", "lib"])
def test_synthetic_arrays_identical(app):
    kw = dict(n_cores=12, length=3000, seed=5, ws_scale=0.125)
    for ref, got in zip(j_syn.generate(app, **kw), t_syn.generate(app, **kw)):
        assert ref.dtype == got.dtype
        np.testing.assert_array_equal(ref, got)
    ph = dict(n_cores=4, length=2000, seed=1)
    for ref, got in zip(j_syn.generate_phased(("kmeans", "lib"), **ph),
                        t_traces.generate_phased(("kmeans", "lib"), **ph)):
        np.testing.assert_array_equal(ref, got)


def _assert_pack_equal(cfg, pcfg, traces, **kw):
    ref = j_engine.pack(cfg, traces, **kw)
    got = t_engine.pack(pcfg, traces, **kw)
    for name, r, g in zip(ref._fields, ref, got):
        assert r.dtype == g.dtype, name
        np.testing.assert_array_equal(r, g, err_msg=name)
    return got


def test_pack_identical_random_batch():
    cfg, pcfg = tp.small_cfg()
    traces = [(*tp.trace(n=n, seed=s), w)
              for n, s, w in ((500, 1, 0), (731, 2, 100), (64, 3, 64))]
    _assert_pack_equal(cfg, pcfg, traces)
    count = [np.arange(len(t[0])) % 3 != 0 for t in traces]
    _assert_pack_equal(cfg, pcfg, traces, pos0=[0, 500, 7], count=count)


def test_pack_edge_cases_identical():
    cfg, pcfg = tp.small_cfg()
    total = cfg.amap.total_sets
    empty = (np.zeros(0, np.uint32), np.zeros(0, bool), np.zeros(0, np.int32))
    pt = _assert_pack_equal(cfg, pcfg, [(*empty, 0)])
    assert pt.conv_tag.shape[2] == 0 and pt.ext_tag.shape[2] == 0
    one_set = (np.arange(100, dtype=np.uint32) * total + 2,
               np.zeros(100, bool), np.zeros(100, np.int32), 0)
    pt = _assert_pack_equal(cfg, pcfg, [one_set])
    assert pt.conv_active[0, 2].sum() == 100 and pt.ext_tag.shape[2] == 0
    for n, expect in ((15, 16), (16, 16), (17, 32), (64, 64), (65, 128)):
        t = (np.arange(n, dtype=np.uint32) * total, np.zeros(n, bool),
             np.zeros(n, np.int32), 0)
        assert _assert_pack_equal(cfg, pcfg, [t]).conv_tag.shape[2] == expect
    cfg, pcfg = tp.small_cfg(chips=0, sets_per_chip=0)     # conv only
    _assert_pack_equal(cfg, pcfg, [(*tp.trace(seed=9), 0)])


# ------------------------------------------- the runtime's workload modules

from repro.workloads import arrivals as j_arr  # noqa: E402
from repro.workloads import corpus as j_corpus  # noqa: E402
from repro.workloads import overload as j_over  # noqa: E402
from repro.workloads import serving as j_serv  # noqa: E402
from repro.workloads import sources as j_src  # noqa: E402
from repro.workloads import tenancy as j_ten  # noqa: E402
from repro_torch.workloads import arrivals as t_arr  # noqa: E402
from repro_torch.workloads import corpus as t_corpus  # noqa: E402
from repro_torch.workloads import overload as t_over  # noqa: E402
from repro_torch.workloads import serving as t_serv  # noqa: E402
from repro_torch.workloads import sources as t_src  # noqa: E402
from repro_torch.workloads import tenancy as t_ten  # noqa: E402

ARRIVALS = ("det:2e6", "poisson:2e6", "mmpp:4e5,6e6,2e-3,6e-4",
            "onoff:6e6,1.5e-3,3e-3")


@pytest.mark.parametrize("spec", ARRIVALS)
def test_arrivals_identical(spec):
    for seed in (0, 1, 5):
        a = j_arr.make_arrival(spec).timestamps(3000, seed=seed)
        b = t_arr.make_arrival(spec).timestamps(3000, seed=seed)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        assert j_arr.burstiness(a) == t_arr.burstiness(b)
        assert j_arr.empirical_rate(a) == t_arr.empirical_rate(b)
        w = float(a[-1] - a[0]) / 7
        assert j_arr.epochs_by_time(a, w, min_requests=20) == \
            t_arr.epochs_by_time(b, w, min_requests=20)
    assert j_arr.make_arrival(spec).mean_rate() == \
        t_arr.make_arrival(spec).mean_rate()
    assert j_arr.epochs_by_count(1001, 300) == t_arr.epochs_by_count(1001, 300)


def test_corpus_files_cross_load(tmp_path):
    a, w, l = t_syn.generate("kmeans", n_cores=4, length=500, seed=2)
    for save, load, name in ((j_corpus.save_trace, t_corpus.load_trace, "r"),
                             (t_corpus.save_trace, j_corpus.load_trace, "p")):
        p = save(tmp_path / f"{name}.npz", a, w, l, name=name, like="kmeans",
                 n_cores=4, seed=2, extra={"k": [1, 2]})
        got = load(p)
        for x, y in zip((a, w, l), got[:3]):
            np.testing.assert_array_equal(x, y)
        assert got[3]["extra"] == {"k": [1, 2]}
        assert j_corpus.validate_trace(p) == t_corpus.validate_trace(p) == []
        assert j_corpus.trace_info(p) == t_corpus.trace_info(p)


@pytest.mark.parametrize("spec", ["synthetic:cfd", "phased:kmeans+lib",
                                  "stencil", "corpus"])
def test_sources_identical(spec, tmp_path):
    if spec == "corpus":
        a, w, l = t_syn.generate("cfd", n_cores=4, length=800, seed=1)
        spec = "corpus:" + str(t_corpus.save_trace(
            tmp_path / "c.npz", a, w, l, like="cfd"))
    js, ts = j_src.make_source(spec), t_src.make_source(spec)
    assert js.name == ts.name and js.app == ts.app
    for seed in (0, 3):
        kw = dict(n_cores=8, length=600, seed=seed, ws_scale=0.125)
        for x, y in zip(js.generate(**kw), ts.generate(**kw)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


WL_SPECS = ("cfd,kmeans", "cfd,kmeans*2,lib", "cfd@0:0.6,kmeans@0.3:",
            "cfd@det:2e6,kmeans@onoff:8e6,1e-3,3e-3")


@pytest.mark.parametrize("spec", WL_SPECS)
def test_tenancy_workloads_identical(spec):
    for seed in (0, 4):
        kw = dict(length=3000, n_cores=16, arrival="mmpp:4e5,6e6,2e-3,6e-4",
                  seed=seed, ws_scale=0.125)
        a, b = j_ten.make_workload(spec, **kw), t_ten.make_workload(spec, **kw)
        assert a.names == b.names and a.primary_app == b.primary_app
        for f in ("addrs", "writes", "levels", "t_s", "tenant_id"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        for x, y in zip(a.tenant_masks(), b.tenant_masks()):
            np.testing.assert_array_equal(x, y)
        for ek in (dict(epoch_len=400), dict(target_epoch=500),
                   dict(window_s=a.span_s / 5)):
            bounds = a.epoch_bounds(**ek)
            assert bounds == b.epoch_bounds(**ek)
        for lo, hi in bounds:
            np.testing.assert_array_equal(a.tenant_counts(lo, hi),
                                          b.tenant_counts(lo, hi))
            assert (a.instructions(lo, hi), a.contention_knee(lo, hi),
                    a.app_at(lo, hi), a.active_signature(lo, hi)) == \
                (b.instructions(lo, hi), b.contention_knee(lo, hi),
                 b.app_at(lo, hi), b.active_signature(lo, hi))
        assert a.has_churn() == b.has_churn()
        assert a.describe() == b.describe()


def test_attribute_stats_identical_and_sums_to_global():
    cfg, pcfg = tp.small_cfg()
    kw = dict(length=2000, n_cores=8, seed=1, ws_scale=0.05)
    wa = j_ten.make_workload("cfd,kmeans", **kw)
    wb = t_ten.make_workload("cfd,kmeans", **kw)
    ref = j_ten.attribute_stats(cfg, wa, warmup=100, backend="jnp")
    got = t_ten.attribute_stats(pcfg, wb, warmup=100, device="cpu")
    assert ref.keys() == got.keys()
    for name in ref:
        tp.assert_stats_equal(ref[name], got[name], ctx=name)
        assert j_ten.hit_rate(ref[name]) == t_ten.hit_rate(got[name])
    whole = t_engine.simulate_parallel(pcfg, wb.addrs, wb.writes, wb.levels,
                                       100, device="cpu")
    for f in ("conv_hits", "conv_misses", "ext_hits", "ext_true_miss"):
        assert sum(int(getattr(s, f)) for s in got.values()) == \
            int(getattr(whole, f)), f


@pytest.mark.parametrize("arrival", ARRIVALS)
def test_serving_schedules_identical(arrival):
    for seed in (0, 2):
        assert j_serv.round_sizes(arrival, 12, 6, seed=seed) == \
            t_serv.round_sizes(arrival, 12, 6, seed=seed)
        assert j_serv.round_requests("a,b+c", arrival, 6, 4, 8, seed=seed) \
            == t_serv.round_requests("a,b+c", arrival, 6, 4, 8, seed=seed)
    mix = "cfd,kmeans"
    a = j_serv.bursty_workload(mix, arrival, length=2000, n_cores=8, seed=3)
    b = t_serv.bursty_workload(mix, arrival, length=2000, n_cores=8, seed=3)
    for f in ("addrs", "writes", "levels", "t_s", "tenant_id"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _drive_budgeters(mod):
    g = mod.SLOBudgeter(slo_ms=2.0, min_batch=1, max_batch=32)
    tenants = [mod.TenantSLO("a", 1.5, weight=2.0, priority=1),
               mod.TenantSLO("b", 3.0)]
    tb = mod.TenantSLOBudgeter(tenants, max_total=40)
    out = []
    batches = mod.tenant_slo_batches("a,b", tb, 4)
    rounds = mod.slo_batches("a,b", g, 4)
    for r in range(12):
        ns = 400.0 + 150.0 * (r % 4)
        g.observe(ns, 8 + r, 2 + r % 5)
        tb.observe({"a": 3 + r % 2, "b": r % 3}, 0.5 + 0.3 * (r % 5),
                   {"a": ns, "b": 2 * ns} if r % 3 else {"a": ns})
        out.append((g.next_budget(), g.attainment(),
                    tb.next_budgets(), tb.next_budgets(["a"]),
                    tb.attainment(), tb.attainment("b"), tb.round_ms(),
                    mod.batch_mix(next(batches)), len(next(rounds))))
    out.append((g.export_state(), tb.export_state()))
    out.append(mod.apportion_largest_remainder([0.2, 1.7, 3.1], 17))
    out.append(mod.proportional_interleave([3, 0, 5, 2]))
    out.append(mod.tenant_prompts("x+y,z", 6))
    return out


def test_serving_budgeters_identical():
    assert _drive_budgeters(j_serv) == _drive_budgeters(t_serv)


@pytest.mark.parametrize("name", sorted(j_over.SCENARIOS))
def test_overload_scenarios_identical(name):
    assert j_over.SHAPES == t_over.SHAPES
    js, ts = j_over.SCENARIOS[name], t_over.SCENARIOS[name]
    assert js.multipliers() == ts.multipliers()
    jt = [j_serv.TenantSLO("hi", 1.0, weight=2, priority=2),
          j_serv.TenantSLO("lo", 4.0)]
    tt = [t_serv.TenantSLO("hi", 1.0, weight=2, priority=2),
          t_serv.TenantSLO("lo", 4.0)]
    a = j_over.demand_schedule(js, jt, 9)
    b = t_over.demand_schedule(ts, tt, 9)
    assert a == b
    assert j_over.offered_totals(a) == t_over.offered_totals(b)


def test_workloads_lazy_exports_match_the_reference():
    import repro.workloads as jw
    import repro_torch.workloads as tw
    assert jw.__all__ == tw.__all__
    for name in ("bursty_workload", "Workload", "make_arrival", "save_trace"):
        assert getattr(tw, name).__module__.startswith("repro_torch.")
    assert tw.TENANT_STRIDE_BLOCKS == jw.TENANT_STRIDE_BLOCKS
    assert tw.SCENARIOS.keys() == jw.SCENARIOS.keys()
