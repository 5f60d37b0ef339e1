"""The port's fleet runtime (``repro_torch.runtime.fleet``) against the
reference's (``repro.runtime.fleet``) and against its own serial loop,
on the CPU.

Against the reference (``backend="jnp"``): decisions, splits and integer
Stats identical, the run's IPC and every epoch's reward within 1e-3
relative (the engine's float contract).  Against the port's own
``run_serial`` and ``simulate_online``: integer Stats and decisions
identical, ``ipc``, rewards and occupancy within 1e-9 relative, as
``tests/test_fleet.py`` holds the reference's fleet to its serial runs.
"""
import types

import jax  # noqa: F401  (both packages in one process, data as numpy)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import one_torch_thread  # noqa: E402,F401
from repro.core import controller as j_ctl  # noqa: E402
from repro.distributed.sharding import fleet_padding as j_padding  # noqa: E402
from repro.runtime import fleet as j_fleet  # noqa: E402
from repro.runtime import governor as j_gov  # noqa: E402
from repro.workloads import serving as j_serv  # noqa: E402
from repro.workloads import tenancy as j_tenancy  # noqa: E402
from repro_torch import obs as t_obs  # noqa: E402
from repro_torch.runtime import fleet as t_fleet  # noqa: E402
from repro_torch.runtime import governor as t_gov  # noqa: E402
from repro_torch.runtime.telemetry import EpochRecord  # noqa: E402
from repro_torch.workloads import serving as t_serv  # noqa: E402
from repro_torch.workloads import tenancy as t_tenancy  # noqa: E402

CANDS = [(18, 50), (32, 36), (48, 20), (68, 0)]


def _ints(stats) -> dict:
    return {f: np.asarray(getattr(stats, f)).tolist()
            for f in j_ctl._INT_FIELDS}


def _splits(result) -> list:
    return [(r.n_compute, r.n_cache) for r in result.records]


def _close(a: float, b: float, rtol: float) -> bool:
    return abs(a - b) <= rtol * max(abs(a), 1.0)


def assert_replica_equal(ref, port, rtol, ctx=""):
    """Integer Stats, decisions and switches identical; ipc, rewards and
    occupancy within ``rtol`` relative."""
    assert _ints(ref.stats) == _ints(port.stats), f"{ctx}: stats"
    assert _splits(ref) == _splits(port), f"{ctx}: decisions"
    assert ref.switches == port.switches, f"{ctx}: switches"
    assert [d.compact() for d in ref.decisions] == \
        [d.compact() for d in port.decisions], f"{ctx}: decision events"
    assert _close(ref.ipc, port.ipc, rtol), f"{ctx}: ipc"
    assert len(ref.records) == len(port.records)
    for a, b in zip(ref.records, port.records):
        assert _close(a.reward, b.reward, rtol), f"{ctx}: reward"
        assert abs(a.ext_occupancy - b.ext_occupancy) <= rtol, ctx
    if ref.tenant_stats:
        assert port.tenant_stats.keys() == ref.tenant_stats.keys()
        for name in ref.tenant_stats:
            assert _ints(ref.tenant_stats[name]) == \
                _ints(port.tenant_stats[name]), f"{ctx}: tenant {name}"


def _specs(mod, rows, **kw):
    """One ``ReplicaSpec`` of package ``mod`` per (app, system, length,
    seed) row."""
    return [mod.ReplicaSpec(app, system, length=length, seed=seed, **kw)
            for app, system, length, seed in rows]


SPECS4 = [("cfd", "Morpheus-ALL", 8_000, 0),
          ("stencil", "Morpheus-ALL", 8_000, 1),
          ("cfd", "Morpheus-ALL", 8_000, 2),
          ("kmeans", "Morpheus-ALL", 8_000, 3)]
MIXED = [("cfd", "Morpheus-ALL", 6_000, 7),
         ("stencil", "Morpheus-ALL", 8_000, 8),
         ("kmeans", "Morpheus-Basic", 6_000, 9)]


# ------------------------------------------------------ N = 1 == scalar

def test_fleet_n1_equals_simulate_online_port_and_reference():
    kw = dict(length=12_000, epoch_len=2_000, seed=0)
    fr = t_fleet.simulate_fleet(
        [t_fleet.ReplicaSpec("cfd", "Morpheus-Basic", **kw)], device="cpu")
    assert fr.n_replicas == 1 and fr.mesh_devices == 1
    assert fr.device == "cpu"
    port = t_gov.simulate_online("cfd", "Morpheus-Basic", device="cpu", **kw)
    assert_replica_equal(port, fr.results[0], 1e-9, "port scalar")
    ref = j_gov.simulate_online("cfd", "Morpheus-Basic", backend="jnp", **kw)
    assert_replica_equal(ref, fr.results[0], 1e-3, "reference scalar")


# ---------------------------------------------- N = 4 against both sides

@pytest.mark.parametrize("rows", [SPECS4, MIXED], ids=["n4", "mixed"])
def test_fleet_matches_reference_fleet_and_port_serial(rows):
    """Same-config groups, mixed systems and lengths (non-power-of-two
    groups pad with no-op rows; replicas finish at different steps)."""
    kw = dict(epoch_len=2_000)
    fr = t_fleet.simulate_fleet(_specs(t_fleet, rows, **kw), device="cpu")
    ref = j_fleet.simulate_fleet(_specs(j_fleet, rows, **kw), backend="jnp")
    serial = t_fleet.run_serial(_specs(t_fleet, rows, **kw), device="cpu")
    assert (fr.epochs, fr.dispatches) == (ref.epochs, ref.dispatches)
    assert fr.names == ref.names
    for i, (r, p, s) in enumerate(zip(ref.results, fr.results, serial)):
        assert_replica_equal(r, p, 1e-3, f"reference replica {i}")
        assert_replica_equal(s, p, 1e-9, f"serial replica {i}")
    if rows is MIXED:
        # mixed systems never share a group, and the 8k replica runs one
        # step alone
        assert fr.dispatches > fr.epochs


def test_fleet_workload_replicas_per_tenant_stats():
    """Multi-tenant workload replicas contribute one state row per
    tenant; per-tenant Stats equal the serial run's and the
    reference's."""
    def specs(mod, tenancy):
        wls = [tenancy.make_workload("cfd,kmeans", length=6_000, n_cores=8,
                                     seed=s) for s in (0, 1)]
        return [mod.ReplicaSpec(wl, "Morpheus-ALL", epoch_len=2_000, seed=s,
                                fixed_split=(48, 20))
                for s, wl in enumerate(wls)]
    fr = t_fleet.simulate_fleet(specs(t_fleet, t_tenancy), device="cpu")
    serial = t_fleet.run_serial(specs(t_fleet, t_tenancy), device="cpu")
    ref = j_fleet.simulate_fleet(specs(j_fleet, j_tenancy), backend="jnp")
    for i, (r, p, s) in enumerate(zip(ref.results, fr.results, serial)):
        assert p.tenant_stats
        assert_replica_equal(r, p, 1e-3, f"reference replica {i}")
        assert_replica_equal(s, p, 1e-9, f"serial replica {i}")


def test_fleet_prefix_is_batching_invariant():
    """Replica i of an N-replica fleet equals replica i of the larger
    fleet whose spec list it prefixes (fig_fleet's invariance claim)."""
    rows = SPECS4 + [("p-bfs", "Morpheus-ALL", 8_000, 4)]
    kw = dict(epoch_len=2_000, candidates=CANDS)
    big = t_fleet.simulate_fleet(_specs(t_fleet, rows, **kw), device="cpu")
    for n in (1, 2):
        small = t_fleet.simulate_fleet(_specs(t_fleet, rows[:n], **kw),
                                       device="cpu")
        for i in range(n):
            assert_replica_equal(big.results[i], small.results[i], 1e-9,
                                 f"N={n} replica {i}")


def test_fleet_device_get_bytes_and_dispatches_match_reference():
    """One engine dispatch a group epoch, counted as the reference counts
    it, and the same bytes read back."""
    kw = dict(epoch_len=2_000, candidates=CANDS)
    counts = {}
    for name, mod, obs_mod, dev in (("port", t_fleet, t_obs,
                                     dict(device="cpu")),
                                    ("ref", j_fleet, None,
                                     dict(backend="jnp"))):
        if obs_mod is None:
            from repro import obs as obs_mod
        obs_mod.enable(trace=False, metrics=True)
        try:
            fr = mod.simulate_fleet(_specs(mod, SPECS4, **kw), **dev)
            counts[name] = (fr.dispatches, obs_mod.bench_counters())
        finally:
            obs_mod.disable()
    (pd, pc), (rd, rc) = counts["port"], counts["ref"]
    assert pd == rd == pc["dispatches"] == rc["dispatches"]
    assert pc["device_get_bytes"] == rc["device_get_bytes"] > 0


def test_fleet_inspector_rides_the_read_back():
    """With the cache inspector on, each replica's snapshots come from the
    group's one read-back and equal its serial run's; results are
    identical with the inspector off."""
    kw = dict(epoch_len=2_000, candidates=CANDS)
    plain = t_fleet.simulate_fleet(_specs(t_fleet, SPECS4[:2], **kw),
                                   device="cpu")
    snaps = {}
    for name, run in (("fleet", t_fleet.simulate_fleet),
                      ("serial", t_fleet.run_serial)):
        t_obs.enable(trace=False, metrics=True, inspect=True)
        try:
            out = run(_specs(t_fleet, SPECS4[:2], **kw), device="cpu")
            snaps[name] = [s.to_dict() for s in t_obs.inspector().snapshots]
        finally:
            t_obs.disable()
        results = out.results if name == "fleet" else out
        for a, b in zip(plain.results, results):
            assert_replica_equal(a, b, 1e-9, f"inspector on, {name}")
    key = (lambda d: (d["replica"], d["epoch"]))
    assert snaps["fleet"] and sorted(snaps["fleet"], key=key) == \
        sorted(snaps["serial"], key=key)


# ------------------------------------------------------- split advisor

def test_split_advisor_warm_start():
    """A replica serving a mix the advisor knows starts AT the advised
    split (with the phase tables when the ladders match), on the
    replica's device, as in the reference."""
    out = {}
    for name, mod, dev in (("port", t_fleet, "cpu"), ("ref", j_fleet, None)):
        kw = dict(length=6_000, epoch_len=2_000, candidates=CANDS)
        build = (lambda s, m=mod, d=dev: s.build(d)) if dev else \
            (lambda s: s.build())
        advisor = mod.SplitAdvisor()
        teacher = build(mod.ReplicaSpec("cfd", "Morpheus-Basic", seed=0,
                                        **kw))
        teacher.gov._i = 3
        teacher.gov.est = {3: 30.0, 2: 25.0}
        teacher.gov.measured = True
        teacher.gov.phase_table[4] = 3
        advisor.report(teacher)
        extra = dict(device=dev) if dev else {}
        warm, = mod.build_replicas(
            [mod.ReplicaSpec("cfd", "Morpheus-Basic", seed=1, **kw)],
            advisor, **extra)
        other, = mod.build_replicas(
            [mod.ReplicaSpec("stencil", "Morpheus-Basic", seed=2, **kw)],
            advisor, **extra)
        out[name] = (advisor.reports, advisor.warm_starts, warm.gov.current,
                     warm.gov.phase_table, other.gov.current,
                     tuple(np.shape(warm.state.conv_tags)))
        if name == "port":
            assert warm.state.pos.device.type == "cpu"
    assert out["port"] == out["ref"]
    assert out["port"][2] == (68, 0) and out["port"][4] == CANDS[2]


def test_split_advisor_mismatched_ladder_nearest_split():
    advisor = t_fleet.SplitAdvisor()
    t = t_fleet.ReplicaSpec("cfd", "Morpheus-Basic", length=6_000,
                            epoch_len=2_000,
                            candidates=[(18, 50), (48, 20)]).build("cpu")
    t.gov._i = 1
    t.gov.est = {1: 30.0}
    t.gov.measured = True
    t.gov.phase_table[2] = 1
    advisor.report(t)
    w = t_fleet.ReplicaSpec("cfd", "Morpheus-Basic", length=6_000,
                            epoch_len=2_000,
                            candidates=[(18, 50), (32, 36),
                                        (68, 0)]).build("cpu")
    assert advisor.warm_start(w)
    assert w.gov.current == (32, 36)      # nearest n_compute to 48
    assert w.gov.phase_table == {}        # ladder mismatch: not inherited
    # the state was rebuilt for the advised split's config
    from repro_torch.core import cache_sim as t_cs
    cfg = t_cs.build_config(t_cs.SYSTEMS["Morpheus-Basic"], 36)
    assert tuple(w.state.ext_tags.shape) == (1, cfg.amap.ext_sets,
                                             cfg.ext_max_ways)


def test_fleet_advisor_end_to_end_matches_reference():
    """Wave 1 teaches; a fresh replica warm-starts at the advised split
    at epoch 0, with the reference's advice and results."""
    kw = dict(length=10_000, epoch_len=2_000,
              candidates=[(18, 50), (24, 44), (32, 36), (48, 20)])
    out = {}
    for name, mod, dev in (("port", t_fleet, dict(device="cpu")),
                           ("ref", j_fleet, dict(backend="jnp"))):
        advisor = mod.SplitAdvisor()
        mod.simulate_fleet([mod.ReplicaSpec("cfd", "Morpheus-ALL", seed=s,
                                            **kw) for s in (0, 1)],
                           advisor=advisor, **dev)
        advised = advisor.table[("Morpheus-ALL", ("cfd",))]["split"]
        warm = mod.simulate_fleet([mod.ReplicaSpec("cfd", "Morpheus-ALL",
                                                   seed=5, **kw)],
                                  advisor=advisor, **dev)
        first = warm.results[0].records[0]
        assert (first.n_compute, first.n_cache) == advised
        assert advisor.warm_starts == 1
        out[name] = (advised, advisor.reports, warm.results[0])
    assert out["port"][:2] == out["ref"][:2]
    assert_replica_equal(out["ref"][2], out["port"][2], 1e-3, "warm")


def test_fleet_warm_start_off_midpoint_rebuilds_state():
    cands = [(18, 50), (24, 44), (32, 36), (48, 20)]
    kw = dict(length=4_000, epoch_len=2_000, candidates=cands)
    advisor = t_fleet.SplitAdvisor()
    teacher = t_fleet.ReplicaSpec("cfd", "Morpheus-ALL", **kw).build("cpu")
    teacher.gov._i = 3
    teacher.gov.est = {3: 9.9}
    teacher.gov.measured = True
    advisor.report(teacher)
    fr = t_fleet.simulate_fleet([t_fleet.ReplicaSpec("cfd", "Morpheus-ALL",
                                                     seed=7, **kw)],
                                advisor=advisor, device="cpu")
    assert advisor.warm_starts == 1
    first = fr.results[0].records[0]
    assert (first.n_compute, first.n_cache) == (48, 20)
    assert fr.summary()["warm_starts"] == 1


# ------------------------------------------------------------ plumbing

@pytest.mark.parametrize("n", [1, 2, 3, 5, 16, 33, 64])
def test_fleet_padding_matches_reference(n):
    assert t_fleet.fleet_padding(n) == j_padding(n)
    padded = n + t_fleet.fleet_padding(n)
    assert padded >= n and padded & (padded - 1) == 0


def test_convergence_epoch():
    def rec(i, nc):
        return EpochRecord(epoch=i, pos=0, app="a", n_compute=nc,
                           n_cache=68 - nc, requests=1, hit_rate=0.5,
                           ext_occupancy=0.0, pred_accuracy=1.0,
                           bytes_saved=0.0, ipc=1.0, exec_time_s=1.0,
                           reward=1.0)
    cases = [[], [rec(0, 32), rec(1, 32)], [rec(0, 32), rec(1, 48),
                                            rec(2, 48)],
             [rec(0, 48), rec(1, 32), rec(2, 48)]]
    assert [t_fleet.convergence_epoch(c) for c in cases] == [0, 0, 1, 2]
    assert [t_fleet.convergence_epoch(c) for c in cases] == \
        [j_fleet.convergence_epoch(c) for c in cases]


def test_evaluate_governors_matrix_matches_reference():
    gcfgs = [t_gov.SERVING_GCFG, t_gov.gcfg_from_dict({"epsilon": 0.05})]
    j_gcfgs = [j_gov.SERVING_GCFG, j_gov.gcfg_from_dict({"epsilon": 0.05})]
    port = t_fleet.evaluate_governors(
        [t_serv.bursty_workload("cfd", "det:2e6", length=9_000)], gcfgs,
        target_epoch=3_000, candidates=[(32, 36), (48, 20)], device="cpu")
    ref = j_fleet.evaluate_governors(
        [j_serv.bursty_workload("cfd", "det:2e6", length=9_000)], j_gcfgs,
        target_epoch=3_000, candidates=[(32, 36), (48, 20)],
        backend="jnp")
    assert len(port) == 2 and len(port[0]) == 1
    for k in range(2):
        assert port[k][0].ipc > 0
        assert_replica_equal(ref[k][0], port[k][0], 1e-3, f"gcfg {k}")


def test_fleet_mesh_over_devices_raises():
    """A fleet axis of more than one rank outside an initialised world (a
    duck-typed mesh) raises a one-line error; an axis of one runs as one
    device.  Fleet axes of 1, 2 and 4 ranks: test_torch_distributed.py."""
    mesh = types.SimpleNamespace(shape={"fleet": 4})
    with pytest.raises(RuntimeError, match="initialised world") as e:
        t_fleet.simulate_fleet(_specs(t_fleet, SPECS4[:1]), device="cpu",
                               mesh=mesh)
    assert "\n" not in str(e.value)
    one = types.SimpleNamespace(shape={"fleet": 1})
    fr = t_fleet.simulate_fleet(
        _specs(t_fleet, [("cfd", "Morpheus-ALL", 2_000, 0)],
               epoch_len=2_000, candidates=CANDS), device="cpu", mesh=one)
    assert fr.mesh_devices == 1 and fr.dispatches == fr.epochs == 1


def test_fleet_entry_points_need_a_device_choice():
    """Without a card the entry points raise instead of running the plain
    versions; replicas built for another device are refused."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.core.engine import BackendError
    specs = _specs(t_fleet, SPECS4[:1], epoch_len=2_000)
    with pytest.raises(BackendError):
        t_fleet.simulate_fleet(specs)
    with pytest.raises(BackendError):
        t_fleet.run_serial(specs)
