"""The port's online runtime (``repro_torch.runtime``) against the
reference's (``repro.runtime``) on the CPU: ``EpochStream`` epochs,
snapshots, state files of either package, warm and cold ``handoff``,
``simulate_online`` in its three forms and ``ServingGovernor`` on the
demo pool.  Integer Stats, decision sequences and state rows are
identical; float Stats within 1e-3 relative (the engine's contract)."""
import dataclasses

import jax  # noqa: F401  (both packages in one process, data as numpy)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401
from repro.core import cache_sim as j_cs  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.runtime import governor as j_gov  # noqa: E402
from repro.runtime import stream as j_stream  # noqa: E402
from repro.workloads import serving as j_serv  # noqa: E402
from repro_torch.core import cache_sim as t_cs  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.kernels import engine_scan as t_scan  # noqa: E402
from repro_torch.runtime import governor as t_gov  # noqa: E402
from repro_torch.runtime import stream as t_stream  # noqa: E402
from repro_torch.workloads import serving as t_serv  # noqa: E402

LADDER = (18, 32, 48, 68)
MMPP = "mmpp:4e5,6e6,2e-3,6e-4"


def _ref_rows(state) -> list:
    return [np.asarray(x) for x in state[:-2]]


def _port_rows(state) -> list:
    return list(t_engine.state_to_numpy(state)[:-2])


def _assert_rows_equal(ref_state, port_state, ctx=""):
    for name, a, b in zip(j_engine.EngineState._fields, _ref_rows(ref_state),
                          _port_rows(port_state)):
        assert a.dtype == b.dtype, f"{ctx} {name}"
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx} {name}")
    tp.assert_stats_equal(ref_state.stats, port_state.stats, ctx)
    np.testing.assert_array_equal(np.asarray(ref_state.pos),
                                  port_state.pos.numpy())


def _cfgs(n_cache=36):
    cfg = j_cs.build_config(j_cs.SYSTEMS["Morpheus-ALL"], n_cache)
    return cfg, t_cs.build_config(t_cs.SYSTEMS["Morpheus-ALL"], n_cache)


def _cfd(length=6000, n_cores=32, seed=0):
    return j_cs.tr.generate("cfd", n_cores=n_cores, length=length, seed=seed,
                            ws_scale=1.0 / j_cs.SIM_SCALE)


@pytest.mark.parametrize("epoch_len", [700, 1500, 4096])
def test_epoch_stream_epochs_match_reference(epoch_len):
    cfg, pcfg = tp.small_cfg()
    a, w, l = tp.trace(n=5000, span=6000, seed=epoch_len)
    js = j_stream.EpochStream(cfg, a, w, l, warmup=300, epoch_len=epoch_len,
                              backend="jnp")
    ts = t_stream.EpochStream(pcfg, a, w, l, warmup=300, epoch_len=epoch_len,
                              device="cpu")
    while not js.done:
        tp.assert_stats_equal(js.step(), ts.step(), f"epoch {js.epoch}")
        assert js.pos == ts.pos
    assert ts.done
    _assert_rows_equal(js.state, ts.state)
    assert js.fp_rate() == ts.fp_rate()
    assert js.probe_counters() == ts.probe_counters()


def test_epoch_stream_tenants_match_reference():
    cfg, pcfg = _cfgs()
    wa = j_serv.bursty_workload("cfd,kmeans", MMPP, length=6000, seed=1)
    wb = t_serv.bursty_workload("cfd,kmeans", MMPP, length=6000, seed=1)
    js = j_stream.EpochStream(cfg, wa, target_epoch=1500, backend="jnp")
    ts = t_stream.EpochStream(pcfg, wb, target_epoch=1500, device="cpu")
    tp.assert_stats_equal(js.run(), ts.run())
    assert js.epoch == ts.epoch and js.churn_events == ts.churn_events
    ja, tb = js.tenant_stats(), ts.tenant_stats()
    assert ja.keys() == tb.keys()
    for name in ja:
        tp.assert_stats_equal(ja[name], tb[name], name)
    _assert_rows_equal(js.state, ts.state)


def test_snapshot_restore_and_ring_resume_identically():
    cfg, pcfg = tp.small_cfg()
    a, w, l = tp.trace(n=6000, span=5000, seed=11)
    whole = t_stream.EpochStream(pcfg, a, w, l, epoch_len=1000,
                                 device="cpu")
    whole.run()
    s = t_stream.EpochStream(pcfg, a, w, l, epoch_len=1000, device="cpu",
                             ring=2)
    for _ in range(3):
        s.step()
    snap = s.snapshot()
    s.run()
    again = t_stream.EpochStream(pcfg, a, w, l, epoch_len=1000,
                                 device="cpu")
    again.restore(snap)
    assert (again.pos, again.epoch) == (3000, 3)
    again.run()
    for st in (s, again):
        for x, y in zip(whole.state, st.state):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y)
        for x, y in zip(whole.state.stats, st.state.stats):
            assert torch.equal(x, y)
    assert again.fp_rate() == whole.fp_rate()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_state_files_load_in_the_other_package(writer, tmp_path):
    """A snapshot file written by one package loads in the other and
    resumes to the uninterrupted run's rows and Stats."""
    cfg, pcfg = _cfgs()
    a, w, l = _cfd()
    ref = j_stream.EpochStream(cfg, a, w, l, epoch_len=1500, backend="jnp")
    ref.run()
    mk = {"reference": lambda: j_stream.EpochStream(
        cfg, a, w, l, epoch_len=1500, backend="jnp"),
        "port": lambda: t_stream.EpochStream(pcfg, a, w, l, epoch_len=1500,
                                             device="cpu")}
    save = {"reference": j_stream.save_state, "port": t_stream.save_state}
    load = {"reference": lambda p: j_stream.load_state(p, cfg),
            "port": lambda p: t_stream.load_state(p, pcfg)}
    reader = "port" if writer == "reference" else "reference"
    src = mk[writer]()
    src.step()
    src.step()
    path = save[writer](tmp_path / "state.npz", src.snapshot())
    snap = load[reader](path)
    assert isinstance(snap, (j_stream.StreamSnapshot,
                             t_stream.StreamSnapshot))
    assert (snap.pos, snap.epoch) == (3000, 2)
    dst = mk[reader]()
    dst.restore(snap)
    dst.run()
    if reader == "port":
        _assert_rows_equal(ref.state, dst.state)
    else:
        for x, y in zip(_ref_rows(ref.state), _ref_rows(dst.state)):
            np.testing.assert_array_equal(x, y)
        tp.assert_stats_equal(ref.state.stats, dst.state.stats)
    # a bare state round-trips too, leaves in the reference's dtypes
    final = dst.state if reader == "port" else t_engine.state_from_numpy(
        pcfg, jax.tree.map(np.asarray, dst.state), "cpu")
    bare = t_stream.load_state(
        t_stream.save_state(tmp_path / "bare.npz", final), pcfg)
    for x, y in zip(_ref_rows(ref.state), bare[:-2]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_load_state_rejects_another_config(tmp_path):
    _, pcfg = _cfgs(36)
    _, other = _cfgs(20)
    path = t_stream.save_state(tmp_path / "s.npz",
                               t_engine.init_state(pcfg, 1, "cpu"))
    with pytest.raises(ValueError, match="shape"):
        t_stream.load_state(path, other)


@pytest.mark.parametrize("migrate,batch,new_cache", [
    (True, 1, 20), (False, 1, 20), (True, 2, 50), (True, 1, 0)])
def test_handoff_matches_reference(migrate, batch, new_cache):
    """Warm and cold handoffs of a warmed-up state: rows, Stats and the
    report equal the reference's field by field, and the rebuilt rows
    are in the CUDA scans' row contract."""
    cfg, pcfg = _cfgs(36)
    new, pnew = _cfgs(new_cache)
    a, w, l = _cfd(length=9000, seed=3)
    traces = [(a, w, l, 0)] * batch
    state = j_engine.init_state(cfg, batch)
    pt = j_engine.pack(cfg, traces)
    state, _ = j_engine.advance_packed(cfg, pt, state, "jnp")
    state = jax.tree.map(np.asarray, state)
    pstate = t_engine.state_from_numpy(pcfg, state, "cpu")
    rs, rrep = j_stream.handoff(cfg, state, new, migrate=migrate)
    ps, prep = t_stream.handoff(pcfg, pstate, pnew, migrate=migrate)
    _assert_rows_equal(rs, ps)
    for f in dataclasses.fields(rrep):
        x, y = getattr(rrep, f.name), getattr(prep, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, f.name
    assert prep.resident_before > 0
    assert (prep.migrated > 0) == migrate
    if migrate:
        t_scan.check_row_contract("conv", t_engine.ctl.ConvRow(
            *[getattr(ps, f) for f in t_engine._CONV_FIELDS]))
        t_scan.check_row_contract("ext", t_engine.ctl.ExtRow(
            *[getattr(ps, f) for f in t_engine._EXT_FIELDS]))
    assert j_stream.flush_energy_nJ_per_block(new) == \
        t_stream.flush_energy_nJ_per_block(pnew)
    blocks = t_stream.extract_blocks(pcfg, pstate)
    for k, v in j_stream.extract_blocks(cfg, state).items():
        np.testing.assert_array_equal(v, blocks[k])


def _decisions(r):
    return [(d.epoch, d.trigger, d.from_split, d.to_split,
             d.flush_writebacks) for d in r.decisions]


def _online_pair(form):
    if form == "stationary":
        kw = dict(length=12_000, epoch_len=1_500)
        system = "Morpheus-Basic"
        cands = j_gov.candidates_for("cfd", system, grid=LADDER,
                                     length=kw["length"])
        return (lambda **d: j_gov.simulate_online(
            "cfd", system, candidates=cands, **kw, **d),
            lambda **d: t_gov.simulate_online(
                "cfd", system, candidates=cands, **kw, **d))
    if form == "phased":
        kw = dict(length=24_000, epoch_len=1_500)
        cands = j_gov.candidates_for("kmeans", "Morpheus-ALL", grid=LADDER,
                                     length=kw["length"])
        return (lambda **d: j_gov.simulate_online(
            ("kmeans", "lib"), "Morpheus-ALL", candidates=cands, **kw, **d),
            lambda **d: t_gov.simulate_online(
                ("kmeans", "lib"), "Morpheus-ALL", candidates=cands, **kw,
                **d))
    wa = j_serv.bursty_workload("cfd,kmeans", MMPP, length=12_000)
    wb = t_serv.bursty_workload("cfd,kmeans", MMPP, length=12_000)
    cands = j_gov.candidates_for(wa.primary_app, "Morpheus-ALL", grid=LADDER,
                                 length=12_000)
    kw = dict(target_epoch=1_500, candidates=cands)
    return (lambda **d: j_gov.simulate_online(
        wa, "Morpheus-ALL", gcfg=j_gov.SERVING_GCFG, **kw, **d),
        lambda **d: t_gov.simulate_online(
            wb, "Morpheus-ALL", gcfg=t_gov.SERVING_GCFG, **kw, **d))


@pytest.mark.parametrize("form", ["stationary", "phased", "tenants"])
def test_simulate_online_matches_reference(form):
    ref_fn, port_fn = _online_pair(form)
    ref, port = ref_fn(backend="jnp"), port_fn(device="cpu")
    assert _decisions(ref) == _decisions(port)
    assert [r.to_dict() for r in ref.records] == \
        [r.to_dict() for r in port.records]
    tp.assert_stats_equal(ref.stats, port.stats, form)
    assert (ref.ipc, ref.converged_split, ref.final_split) == \
        (port.ipc, port.converged_split, port.final_split)
    if form == "tenants":
        assert ref.tenant_stats.keys() == port.tenant_stats.keys()
        for name in ref.tenant_stats:
            tp.assert_stats_equal(ref.tenant_stats[name],
                                  port.tenant_stats[name], name)
        for f in t_engine.ctl._INT_FIELDS:
            assert sum(int(getattr(s, f))
                       for s in port.tenant_stats.values()) == \
                int(getattr(port.stats, f)), f
        assert port.tenant_hit_rates() == ref.tenant_hit_rates()


def test_governor_host_logic_matches_reference():
    d = {"hysteresis": 4.0, "min_gain": 1, "phase_memory": 0,
         "tenant_weights": [1, 2]}
    assert dataclasses.asdict(j_gov.gcfg_from_dict(d)) == \
        dataclasses.asdict(t_gov.gcfg_from_dict(d))
    with pytest.raises(ValueError):
        t_gov.gcfg_from_dict({"hysterisis": 1})
    for obj in ("weighted", "minf"):
        for w in (None, (1.0, 3.0, 0.0)):
            g = (j_gov.GovernorConfig(objective=obj, tenant_weights=w),
                 t_gov.GovernorConfig(objective=obj, tenant_weights=w))
            for ipcs, counts in (([1.0, 2.0, 3.0], [5, 0, 2]),
                                 ([0.5, 0.25, 4.0], [1, 1, 1])):
                assert j_gov.qos_reward(g[0], ipcs, counts) == \
                    t_gov.qos_reward(g[1], ipcs, counts)
    for c in ("cfd", "kmeans", "spmv"):
        assert j_gov.candidates_for(c, "Morpheus-ALL", grid=LADDER) == \
            t_gov.candidates_for(c, "Morpheus-ALL", grid=LADDER)


def _chat_keys(n_batches=24, size=12, seed=0):
    rng = np.random.default_rng(seed)
    hot = rng.integers(1, 1 << 30, size=40)
    for i in range(n_batches):
        span = 120 if i < n_batches // 2 else 900   # the working set grows
        cold = rng.integers(1, 1 << 30, size=span)
        pick = np.where(rng.random(size) < 0.6, rng.choice(hot, size),
                        rng.choice(cold, size))
        yield pick.astype(np.uint32)


def test_serving_governor_ticks_match_reference():
    jp, tpool = j_gov.demo_pool(4), t_gov.demo_pool(4, device="cpu")
    jg = j_gov.ServingGovernor(jp)
    tg = t_gov.ServingGovernor(tpool)
    for i, keys in enumerate(_chat_keys()):
        if i % 7 != 6:                      # every 7th window is idle
            jp.lookup_batch(keys)
            tpool.lookup_batch(keys)
        a, b = jg.tick(), tg.tick()
        assert a == b, i
        assert t_gov.describe_tick(b) == j_gov.describe_tick(a)
        assert tuple(jg.pool.stats) == tuple(tg.pool.stats)
    assert [e.to_dict() for e in jg.gov.decisions] == \
        [e.to_dict() for e in tg.gov.decisions]
    assert sum(r["switched"] for r in tg.history) >= 5
    assert sum(r["flushed_pages"] for r in tg.history) > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    from repro_torch.core.engine import BackendError
    _, pcfg = tp.small_cfg()
    a, w, l = tp.trace(n=100)
    with pytest.raises(BackendError):
        t_stream.EpochStream(pcfg, a, w, l, epoch_len=50)
    with pytest.raises(BackendError):
        t_gov.simulate_online("cfd", "Morpheus-Basic", length=3000)
    with pytest.raises(BackendError):
        t_gov.demo_pool(2)


def test_serving_governor_snapshots_match_reference_with_inspector_on():
    """With the cache-content inspector on, each busy tick records the
    pool's decoded snapshot (owners from the inspector's notes); the
    port's snapshots and counters equal the reference's."""
    from repro import obs as j_obs
    from repro_torch import obs as t_obs
    keys = list(_chat_keys(n_batches=8, size=10, seed=3))
    snaps, counters = [], []
    for obs, gov, kw in ((j_obs, j_gov, {}), (t_obs, t_gov, {"device": "cpu"})):
        obs.disable()
        obs.enable(trace=False, inspect=True)
        ins = obs.inspector()
        for i, k in enumerate(keys[0]):
            ins.note_owner(int(k), "ab"[i % 2])
        pool = gov.demo_pool(2, **kw)
        sg = gov.ServingGovernor(pool)
        for batch in keys:
            pool.lookup_batch(batch)
            sg.tick()
        snaps.append([s.to_dict() for s in ins.snapshots])
        counters.append(obs.bench_counters())
        obs.disable()
    assert snaps[0] == snaps[1] and len(snaps[1]) == len(keys)
    assert counters[0]["snapshots"] == counters[1]["snapshots"] == len(keys)
    assert any(s["residency"].get("a") for s in snaps[1])
