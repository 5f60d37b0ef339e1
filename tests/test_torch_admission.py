"""The port's admission control (``repro_torch.runtime.admission``)
against the reference's (``repro.runtime.admission``) on the CPU.

The controller is host code: its event traces equal the reference's on
the canonical scenarios (the ``GOLDEN_CRC`` pins of tests/scenarios.py)
and on ``hypothesis``-drawn demand histories, byte for byte.  The
overload loop runs the engine's count-masked tenant rows: rounds
(served, deferred, shed), decisions and integer global and per-tenant
Stats identical to the reference's, floats within 1e-3.  The serving
state rides ``EpochStream`` snapshots and ``.npz`` files of either
package."""
import json
import zlib

import jax  # noqa: F401  (both packages in one process, data as numpy)
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import scenarios as sc  # noqa: E402
import torch_parity as tp  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401
from repro.runtime import admission as j_adm  # noqa: E402
from repro.runtime import stream as j_stream  # noqa: E402
from repro.workloads import overload as j_over  # noqa: E402
from repro.workloads import serving as j_serv  # noqa: E402
from repro_torch import obs as t_obs  # noqa: E402
from repro_torch.core.controller import _INT_FIELDS  # noqa: E402
from repro_torch.runtime import admission as t_adm  # noqa: E402
from repro_torch.runtime import stream as t_stream  # noqa: E402
from repro_torch.workloads import overload as t_over  # noqa: E402
from repro_torch.workloads import serving as t_serv  # noqa: E402

PKG = {"ref": (j_adm, j_over, j_serv), "port": (t_adm, t_over, t_serv)}


def _tenants(serv, rows):
    return [serv.TenantSLO(*r[:2], weight=r[2], priority=r[3], app=r[4])
            for r in rows]


TENANTS3 = [("hi", 4.0, 2.0, 2, "cfd"), ("mid", 8.0, 1.0, 1, "kmeans"),
            ("lo", 16.0, 1.0, 0, "histo")]
TENANTS2 = [("a", 4.0, 2.0, 1, "cfd"), ("b", 8.0, 1.0, 0, "kmeans")]
CANDS = [(60, 8), (52, 16)]


def run_scenario(pkg: str, name: str, cfg_kw=None):
    """tests/scenarios.py's ``run_controller`` on either package."""
    adm, over, serv = PKG[pkg]
    tenants = _tenants(serv, TENANTS3)
    ctrl = adm.AdmissionController(tenants, adm.AdmissionConfig(
        **(cfg_kw or {})))
    shares = serv.apportion_largest_remainder([t.weight for t in tenants],
                                              sc.CAPACITY)
    budgets = dict(zip([t.name for t in tenants], shares))
    plans = [ctrl.plan(d, budgets) for d in over.demand_schedule(
        over.SCENARIOS[name], tenants, sc.BASE_TOTAL)]
    return ctrl, plans


def _trace(ctrl) -> str:
    return ";".join(e.compact() for e in ctrl.events)


# ------------------------------------------------- pinned goldens

@pytest.mark.parametrize("name", sorted(sc.GOLDEN_CRC))
def test_port_controller_gives_golden_event_crcs(name):
    ctrl, plans = run_scenario("port", name)
    ref, _ = run_scenario("ref", name)
    assert _trace(ctrl) == _trace(ref)
    assert zlib.crc32(_trace(ctrl).encode()) & 0xFFFFFFFF == \
        sc.GOLDEN_CRC[name]
    assert ctrl.export_state() == ref.export_state()
    assert [e.to_dict() for e in ctrl.events] == \
        [e.to_dict() for e in ref.events]
    for p in plans:
        assert p.total_served <= sc.CAPACITY


def test_port_disabled_controller_is_inert():
    ctrl, plans = run_scenario("port", "sustained8", dict(enabled=False))
    assert ctrl.events == [] and ctrl.backlog() == 0
    assert all(p.pressure == 0.0 and not p.events for p in plans)


# ----------------------------------------- drawn histories (properties)

def _draw(data):
    k = data.draw(st.integers(2, 4))
    rows = [(f"t{i}", 5.0, 1.0, data.draw(st.integers(0, 3)), "")
            for i in range(k)]
    cfg = dict(age_boost=data.draw(st.integers(1, 4)),
               defer_cap=data.draw(st.integers(1, 16)))
    cap = data.draw(st.integers(1, 12))
    history = [{r[0]: data.draw(st.integers(0, 10)) for r in rows}
               for _ in range(data.draw(st.integers(5, 25)))]
    return rows, cfg, cap, history


def _replay(pkg, rows, cfg, cap, history):
    adm, _, serv = PKG[pkg]
    tenants = _tenants(serv, rows)
    budgets = dict(zip([t.name for t in tenants],
                       serv.apportion_largest_remainder([1.0] * len(rows),
                                                        cap)))
    ctrl = adm.AdmissionController(tenants, adm.AdmissionConfig(**cfg))
    plans = [ctrl.plan(d, budgets) for d in history]
    return ctrl, plans


@settings(max_examples=25, deadline=None, derandomize=True)
@given(st.data())
def test_event_traces_equal_reference_on_drawn_histories(data):
    """The port's plans, events, counters and queues equal the
    reference's for any demand history, priorities and config."""
    drawn = _draw(data)
    (pc, pp), (rc, rp) = (_replay(p, *drawn) for p in ("port", "ref"))
    assert _trace(pc) == _trace(rc)
    assert pc.counters == rc.counters and pc.queues == rc.queues
    for a, b in zip(pp, rp):
        assert (a.admitted, a.resumed, a.deferred, a.shed, a.pressure) == \
            (b.admitted, b.resumed, b.deferred, b.shed, b.pressure)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(st.data())
def test_port_starvation_freedom_on_drawn_histories(data):
    """tests/test_properties.py's aging bound, on the port's controller."""
    rows, cfg, cap, history = _draw(data)
    ctrl, plans = _replay("port", rows, cfg, cap, history)
    bound = cfg["age_boost"] + -(-len(rows) * cfg["defer_cap"] // cap) + 1
    for demand, p in zip(history, plans):
        for n in demand:
            assert demand[n] == p.admitted[n] + p.deferred[n] + p.shed[n]
        assert p.total_served <= cap
    assert all(ctrl.oldest_age(r[0]) <= bound for r in rows)


# ------------------------------------------------- the overload loop

def _overload(pkg, rows, load, rounds, base, mode="on", **kw):
    adm, over, serv = PKG[pkg]
    tenants = _tenants(serv, rows)
    scn = over.LoadScenario("s", "sustained", load, rounds=rounds)
    admission = {"on": adm.AdmissionConfig(), "off": None,
                 "disabled": adm.AdmissionConfig(enabled=False)}[mode]
    dev = dict(device="cpu") if pkg == "port" else dict(backend="jnp")
    return adm.simulate_overload(tenants, over.demand_schedule(
        scn, tenants, base), admission=admission, **dev, **kw)


def _ints(stats) -> dict:
    return {f: int(np.asarray(getattr(stats, f))) for f in _INT_FIELDS}


def _rounds(res) -> list:
    keys = ("served", "deferred", "shed", "budget", "split", "backlog",
            "idle")
    return [{k: r.get(k) for k in keys} for r in res.rounds]


@pytest.mark.parametrize("rows,load,rounds,base,kw", [
    (TENANTS2, 4.0, 8, 20, dict(candidates=CANDS, max_total=24, seed=2)),
    (TENANTS3, 6.0, 6, 24, dict(candidates=[(32, 36), (48, 20)],
                                max_total=48, seed=7)),
], ids=["two-tenants", "three-tenants"])
def test_simulate_overload_matches_reference(rows, load, rounds, base, kw):
    port = _overload("port", rows, load, rounds, base, **kw)
    ref = _overload("ref", rows, load, rounds, base, **kw)
    assert _rounds(port) == _rounds(ref)
    assert [e.compact() for e in port.events] == \
        [e.compact() for e in ref.events]
    assert [d.compact() for d in port.decisions] == \
        [d.compact() for d in ref.decisions]
    assert _ints(port.stats) == _ints(ref.stats)
    tp.assert_stats_equal(ref.stats, port.stats, "global")
    for n in ref.tenant_stats:
        assert _ints(port.tenant_stats[n]) == _ints(ref.tenant_stats[n]), n
    for a, b in zip(port.rounds, ref.rounds):
        assert abs(a["round_ms"] - b["round_ms"]) <= \
            1e-3 * max(b["round_ms"], 1.0)
    assert (port.offered, port.served, port.shed, port.backlog) == \
        (ref.offered, ref.served, ref.shed, ref.backlog)
    assert port.attribution_exact() and sum(port.shed.values()) > 0
    for n in port.offered:
        assert port.offered[n] == port.served[n] + port.shed[n] \
            + port.backlog[n]


def test_overload_disabled_equals_absent():
    kw = dict(candidates=CANDS, max_total=48, seed=5)
    runs = [_overload("port", TENANTS2, 3.0, 6, 18, mode=m, **kw)
            for m in ("off", "disabled")]
    assert _ints(runs[0].stats) == _ints(runs[1].stats)
    for n in ("a", "b"):
        assert _ints(runs[0].tenant_stats[n]) == \
            _ints(runs[1].tenant_stats[n])
    assert [d.compact() for d in runs[0].decisions] == \
        [d.compact() for d in runs[1].decisions]
    assert [r["served"] for r in runs[0].rounds] == \
        [r["served"] for r in runs[1].rounds]
    assert runs[0].events == [] and runs[1].events == []
    assert runs[0].summary()["rounds"] == 6


def test_admission_events_flow_through_port_obs():
    t_obs.enable(trace=True, metrics=True)
    try:
        ctrl, _ = run_scenario("port", "sustained2")
        got = t_obs.admission_counters(t_obs.metrics_registry())
        assert got == {k: ctrl.counters[k] for k in got}
        assert sum(got.values()) > 0
        names = [e["name"] for e in
                 t_obs.tracer().to_chrome()["traceEvents"]
                 if e.get("ph") == "i"]
        assert "admission.event" in names
    finally:
        t_obs.disable()


# ------------------------------------------------- snapshot carry

def _warmed(pkg):
    adm, _, serv = PKG[pkg]
    tenants = _tenants(serv, TENANTS3)
    b = serv.TenantSLOBudgeter(tenants)
    b.observe({"hi": 8, "mid": 4, "lo": 4}, 3.0)
    b.observe({"hi": 6, "mid": 6, "lo": 2}, 5.0)
    c = adm.AdmissionController(tenants, adm.AdmissionConfig(age_boost=2))
    budgets = dict(zip([t.name for t in tenants],
                       serv.apportion_largest_remainder(
                           [t.weight for t in tenants], sc.CAPACITY)))
    c.plan({"hi": 30, "mid": 20, "lo": 20}, budgets)
    c.plan({"hi": 30, "mid": 20, "lo": 20}, budgets)
    return b, c


def _fresh(pkg):
    adm, _, serv = PKG[pkg]
    tenants = _tenants(serv, TENANTS3)
    return (serv.TenantSLOBudgeter(tenants),
            adm.AdmissionController(tenants, adm.AdmissionConfig(
                age_boost=2)))


def test_port_snapshot_carries_serving_state(tmp_path):
    """Budgeter and admission state survive the port's ``snapshot`` /
    ``restore`` and ``save_state`` / ``load_state``."""
    cfg, pcfg = tp.small_cfg()
    a, w, l = tp.trace(n=1200, span=1024)
    st1 = t_stream.EpochStream(pcfg, a, w, l, epoch_len=300, device="cpu")
    bud, ctrl = _warmed("port")
    st1.attach_serving(bud, ctrl)
    st1.step()
    snap = st1.snapshot()
    assert snap.serving is not None and len(snap.serving) == 2
    bud2, ctrl2 = _fresh("port")
    st2 = t_stream.EpochStream(pcfg, a, w, l, epoch_len=300, device="cpu")
    st2.attach_serving(bud2, ctrl2)
    st2.restore(snap)
    assert ctrl2.export_state() == ctrl.export_state()
    assert bud2.export_state() == bud.export_state()
    assert ctrl2.oldest_age("lo") == ctrl.oldest_age("lo") > 0
    p = t_stream.save_state(tmp_path / "snap.npz", snap)
    loaded = t_stream.load_state(p, pcfg, batch=1)
    assert json.dumps(list(loaded.serving), sort_keys=True) == \
        json.dumps(list(snap.serving), sort_keys=True)
    bud3, ctrl3 = _fresh("port")
    st3 = t_stream.EpochStream(pcfg, a, w, l, epoch_len=300, device="cpu")
    st3.attach_serving(bud3, ctrl3)
    st3.restore(loaded)
    assert ctrl3.export_state() == ctrl.export_state()
    st3.step()
    assert st3.pos == st1.pos + 300


def test_reference_npz_with_serving_payload_loads_in_port(tmp_path):
    """A state file the reference wrote with a budgeter and a controller
    attached restores the port's components to the same state."""
    cfg, pcfg = tp.small_cfg()
    a, w, l = tp.trace(n=1200, span=1024)
    ref = j_stream.EpochStream(cfg, a, w, l, epoch_len=300, backend="jnp")
    bud, ctrl = _warmed("ref")
    ref.attach_serving(bud, ctrl)
    ref.step()
    path = j_stream.save_state(tmp_path / "ref.npz", ref.snapshot())
    loaded = t_stream.load_state(path, pcfg, batch=1)
    port = t_stream.EpochStream(pcfg, a, w, l, epoch_len=300, device="cpu")
    bud2, ctrl2 = _fresh("port")
    port.attach_serving(bud2, ctrl2)
    port.restore(loaded)
    assert ctrl2.export_state() == ctrl.export_state()
    assert bud2.export_state() == bud.export_state()
    assert port.pos == ref.pos
    tp.assert_stats_equal(ref.step(), port.step(), "next epoch")
