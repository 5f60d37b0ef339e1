"""The port's observability layer (``repro_torch.obs``) against the
reference's (``repro.obs``): tracer output with an injected clock, the
registry's exposition, the ``DecisionEvent`` contract, the governor's
decision streams, reuse histograms, working-set curves, Jain's index and
decoded state snapshots are identical; the build probe counts ``nvcc``
runs; and the port's engine, pool and ``simulate_online`` give
bit-identical results with observability on and off."""
import json

import jax  # noqa: F401  (both packages in one process, data as numpy)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401
from repro import obs as j_obs  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.obs import decision as j_dec  # noqa: E402
from repro.obs import inspect as j_ins  # noqa: E402
from repro.obs import metrics as j_met  # noqa: E402
from repro.obs import profile as j_prof  # noqa: E402
from repro.obs import trace as j_trace  # noqa: E402
from repro.runtime import governor as j_gov  # noqa: E402
from repro.runtime import telemetry as j_tel  # noqa: E402
from repro_torch import obs as t_obs  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.obs import decision as t_dec  # noqa: E402
from repro_torch.obs import inspect as t_ins  # noqa: E402
from repro_torch.obs import metrics as t_met  # noqa: E402
from repro_torch.obs import profile as t_prof  # noqa: E402
from repro_torch.obs import trace as t_trace  # noqa: E402
from repro_torch.runtime import governor as t_gov  # noqa: E402
from repro_torch.runtime import telemetry as t_tel  # noqa: E402
from repro_torch.serving import paged_kv as t_kv  # noqa: E402


@pytest.fixture(autouse=True)
def _obs_off():
    """Every test starts and ends with both packages' obs disabled."""
    j_obs.disable()
    t_obs.disable()
    yield
    j_obs.disable()
    t_obs.disable()


def test_public_names_match_the_reference():
    names = ("enable", "disable", "span", "count", "instant", "inspector",
             "metrics_on", "set_gauge", "bench_counters", "enabled",
             "tracing", "tracer", "metrics_registry", "observe",
             "DecisionEvent", "AdmissionEvent", "TRIGGERS",
             "ADMISSION_KINDS", "Inspector", "Snapshot", "Registry",
             "Tracer", "NULL_SPAN")
    for n in names:
        assert hasattr(j_obs, n) and hasattr(t_obs, n), n
    assert t_obs.span("x") is t_obs.NULL_SPAN


def _drive_tracer(mod):
    ticks = iter(range(0, 1_000_000, 1_000))
    t = mod.Tracer(clock=lambda: next(ticks))
    with t.span("outer", layer="runtime"):
        with t.span("inner") as sp:
            sp.set(rows=4, split=(32, 36))
        t.instant("mark", why="because", v=np.int64(3))
    with t.span("outer"):
        pass
    return t


def test_tracer_output_identical_with_injected_clock(tmp_path):
    a, b = _drive_tracer(j_trace), _drive_tracer(t_trace)
    assert a.to_json() == b.to_json()
    assert a.summary() == b.summary()
    assert a.save(tmp_path / "a.json").read_text() == \
        b.save(tmp_path / "b.json").read_text()


def _fill_registry(mod):
    r = mod.Registry()
    r.counter("engine_dispatches", "dispatches issued").inc(3, path="epoch")
    r.counter("engine_dispatches").inc(2, path="fleet")
    r.gauge("slo_attainment", "met rounds").set(0.75, tenant="a")
    h = r.histogram("span_ns", buckets=(10, 100))
    for v in (5, 50, 5000):
        h.observe(v, kind="x")
    r.counter("epochs").inc(7)
    return r


def test_registry_exposition_identical(tmp_path):
    a, b = _fill_registry(j_met), _fill_registry(t_met)
    assert a.to_prometheus() == b.to_prometheus()
    assert a.snapshot() == b.snapshot()
    for suffix in (".json", ".prom"):
        assert a.save(tmp_path / f"a{suffix}").read_text() == \
            b.save(tmp_path / f"b{suffix}").read_text()
    assert j_met.bench_counters(a) == t_met.bench_counters(b)
    assert j_met.admission_counters(a) == t_met.admission_counters(b)


def test_bench_counter_keys_point_compiles_at_the_build_counter():
    assert t_met.BENCH_COUNTER_KEYS.keys() == j_met.BENCH_COUNTER_KEYS.keys()
    assert t_met.BENCH_COUNTER_KEYS["compiles"] == "kernel_builds"
    assert {k: v for k, v in t_met.BENCH_COUNTER_KEYS.items()
            if k != "compiles"} == \
        {k: v for k, v in j_met.BENCH_COUNTER_KEYS.items()
         if k != "compiles"}


def test_build_probe_counts_nvcc_runs(tmp_path, monkeypatch):
    """``_build.build`` counts each compiler run (and its seconds) into
    the active registry, and nothing when no registry is active or the
    library is already built."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: "true")

    def fake_run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        open(out, "w").close()
        return type("P", (), {"returncode": 0, "stdout": "", "stderr": ""})

    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    t_obs.enable(trace=False)
    _build.build("k")
    _build.build("k")                   # already built: no nvcc run
    c = t_obs.bench_counters()
    reg = t_obs.metrics_registry()
    assert c["compiles"] == 1
    assert reg.get("kernel_build_seconds").total() >= 0
    assert reg.get("kernel_builds").samples() == [
        {"labels": {"source": "k"}, "value": 1}]
    t_obs.disable()
    (src / "k.cu").write_text("// edited\n")
    _build.build("k")                   # rebuilt, but no registry
    assert t_obs.metrics_registry() is None


def test_decision_event_contract_identical():
    assert t_dec.TRIGGERS == j_dec.TRIGGERS
    assert t_dec.ADMISSION_KINDS == j_dec.ADMISSION_KINDS
    for cls in ("DecisionEvent", "AdmissionEvent"):
        jf = list(getattr(j_dec, cls).__dataclass_fields__)
        tf = list(getattr(t_dec, cls).__dataclass_fields__)
        assert jf == tf, cls
    for frm, to in ((32, 36), (28, 40)), ((32, 36), (32, 36)):
        evs = [m.DecisionEvent(epoch=3, trigger="hint",
                               from_split=frm, to_split=to,
                               epsilon=0.2, hint=1,
                               estimates={"(32, 36)": 1.5},
                               summary={"hit_rate": 0.25})
               for m in (j_dec, t_dec)]
        assert evs[0].to_dict() == evs[1].to_dict()
        assert evs[0].compact() == evs[1].compact()
        assert evs[0].switched == evs[1].switched
    a = [m.AdmissionEvent(round=2, kind="resume", tenant="lo", requests=3,
                          age=4, pressure=1.5) for m in (j_dec, t_dec)]
    assert a[0].to_dict() == a[1].to_dict() and \
        a[0].compact() == a[1].compact()
    with pytest.raises(AssertionError):
        t_dec.DecisionEvent(epoch=0, trigger="vibes", from_split=0,
                            to_split=1, epsilon=0.0)


def _drive(gov, reward_fn, epochs, hint=0, sig=None, ctx=None):
    for _ in range(epochs):
        if ctx is not None:
            gov.set_context(ctx)
        kw = {} if sig is None else {"signature": sig}
        gov.observe(reward_fn(gov.current), hint=hint, **kw)
        gov.decide()


def _scenario(mod, name):
    """The reference test's governor scenarios (tests/test_obs.py),
    which together fire every trigger of ``TRIGGERS``."""
    cfg = mod.GovernorConfig
    if name == "greedy_explore":
        cands = [(n, 68 - n) for n in (10, 20, 30, 40, 50, 60)]
        peak = {c: 100.0 - abs(c[0] - 40) for c in cands}
        gov = mod.Governor(cands, cfg(seed=3, warm_epochs=0))
        _drive(gov, lambda c: peak[c], 60)
    elif name == "hint":
        gov = mod.Governor(list(range(5)), cfg(seed=0, warm_epochs=0),
                           initial=2)
        _drive(gov, lambda c: 10.0, 12, hint=+1)
    elif name == "phase":
        gov = mod.Governor(list(range(6)), cfg(seed=2, warm_epochs=0))
        _drive(gov, lambda c: 50.0 - 5 * c, 40, sig=0.15)
        _drive(gov, lambda c: 30.0 + 5 * c, 60, sig=0.90)
        _drive(gov, lambda c: 50.0 - 5 * c, 3, sig=0.15)
    else:
        gov = mod.Governor(list(range(6)), cfg(seed=1, warm_epochs=0))
        _drive(gov, lambda c: 50.0 - 5 * c, 40, ctx=0b11)
        _drive(gov, lambda c: 30.0 + 5 * c, 50, ctx=0b01)
        _drive(gov, lambda c: 50.0 - 5 * c, 2, ctx=0b11)
    return gov


SCENARIOS = ("greedy_explore", "hint", "phase", "churn")


@pytest.mark.parametrize("name", SCENARIOS)
def test_governor_decision_streams_identical(name):
    a, b = _scenario(j_gov, name), _scenario(t_gov, name)
    assert [e.to_dict() for e in a.decisions] == \
        [e.to_dict() for e in b.decisions]
    sa, sb = a.export_state(), b.export_state()
    assert sa._asdict() == sb._asdict()
    assert (a.switches, a.phase_shifts, a.phase_jumps, a.churn_resets) == \
        (b.switches, b.phase_shifts, b.phase_jumps, b.churn_resets)


def test_scenarios_cover_every_trigger():
    fired = {e.trigger for n in SCENARIOS
             for e in _scenario(t_gov, n).decisions}
    assert fired == set(t_dec.TRIGGERS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_profile_identical(seed):
    rng = np.random.default_rng(seed)
    addrs = rng.integers(0, 300, size=2_000).astype(np.uint32)
    tid = rng.integers(0, 3, size=2_000)
    a = j_prof.profile_trace(addrs, tenant_id=tid, names=["a", "b", "c"],
                             points=16)
    b = t_prof.profile_trace(addrs, tenant_id=tid, names=["a", "b", "c"],
                             points=16)
    assert a == b
    assert b["reuse"]["mass"] == len(addrs)
    np.testing.assert_array_equal(j_prof.reuse_distances(addrs[:500]),
                                  t_prof.reuse_distances(addrs[:500]))


@pytest.mark.parametrize("xs", [[], [1.0], [2.0, 2.0, 2.0], [1.0, 0.0],
                                [0.3, 1.7, 2.9, 0.01], [0.0, 0.0]])
def test_jains_index_identical(xs):
    assert t_tel.jains_index(xs) == j_tel.jains_index(xs)


def test_telemetry_log_export_identical(tmp_path):
    def log(mod):
        lg = mod.TelemetryLog(capacity=4)
        for e in range(7):
            lg.append(mod.EpochRecord(
                epoch=e, pos=e * 100, app="cfd", n_compute=32, n_cache=36,
                requests=100, hit_rate=0.5, ext_occupancy=0.25,
                pred_accuracy=0.9, bytes_saved=12.0, ipc=1.5,
                exec_time_s=1e-4, reward=1.5, switched=e == 3,
                decision="hint:(32|36)->(48|20)" if e == 3 else ""))
        return lg
    a, b = log(j_tel), log(t_tel)
    assert [r.to_dict() for r in a.records()] == \
        [r.to_dict() for r in b.records()]
    assert j_tel.FIELDS == t_tel.FIELDS
    assert a.to_csv(tmp_path / "a.csv").read_text() == \
        b.to_csv(tmp_path / "b.csv").read_text()


def _ref_state_after_epochs(cfg, n_epochs=3, batch=1):
    addrs, writes, levels = tp.trace(n=900, span=4096, seed=7)
    state = j_engine.init_state(cfg, batch)
    for e in range(n_epochs):
        sl = slice(e * 300, (e + 1) * 300)
        pt = j_engine.pack(cfg, [(addrs[sl], writes[sl], levels[sl], 0)]
                           * batch, pos0=[e * 300] * batch)
        state, _ = j_engine.advance_packed(cfg, pt, state, "jnp")
    return jax.tree.map(np.asarray, state)


def test_decoded_snapshot_identical():
    cfg, pcfg = tp.small_cfg()
    ref = _ref_state_after_epochs(cfg)
    port = t_engine.state_from_numpy(pcfg, ref, "cpu")
    dj = j_engine.decode_state(cfg, ref)
    dt = t_engine.decode_state(pcfg, port)
    assert dj.keys() == dt.keys()
    for k in dj:
        np.testing.assert_array_equal(np.asarray(dj[k]), np.asarray(dt[k]),
                                      err_msg=k)
        assert np.asarray(dj[k]).dtype == np.asarray(dt[k]).dtype, k
    kw = dict(epoch=2, replica="r", conv_ways=cfg.conv_ways,
              ext_max_ways=cfg.ext_max_ways,
              ext_budget_bytes=cfg.ext_budget_bytes, block_bytes=128,
              tenant_stride=64, tenant_names=["a", "b"],
              probe_counters=(3, 9))
    sa = j_ins.snapshot_from_decode(dj, **kw)
    sb = t_ins.snapshot_from_decode(dt, **kw)
    assert sa.to_dict() == sb.to_dict()


def _demo_keys(n=48, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 3000, size=n).astype(np.uint32)


def test_pool_content_snapshot_identical():
    from repro.serving import paged_kv as j_kv
    cfg = dict(conv_sets=8, ext_sets_per_chip=4, num_cache_chips=2, ways=4)
    jp = j_kv.MorpheusPagePool(j_kv.PoolConfig(**cfg))
    tpool = t_kv.MorpheusPagePool(t_kv.PoolConfig(**cfg), device="cpu")
    keys = _demo_keys()
    for batch in np.split(keys, 4):
        jp.lookup_batch(batch)
        tpool.lookup_batch(batch)
    owners = {int(k): ("a" if i % 2 else "b") for i, k in enumerate(keys)}
    del owners[int(keys[0])]
    sa = jp.content_snapshot(epoch=3, owners=owners)
    sb = tpool.content_snapshot(epoch=3, owners=owners)
    assert sa.to_dict() == sb.to_dict()
    assert sum(sb.residency.values()) == \
        sum(sb.conv_set_occ) + sum(sb.ext_set_occ)


def test_trace_recorder_save_loads_in_the_reference(tmp_path):
    from repro.serving import paged_kv as j_kv
    from repro.workloads import corpus as j_corpus
    recs = [j_kv.TraceRecorder(capacity=16), t_kv.TraceRecorder(capacity=16)]
    for r in recs:
        r.record(j_kv.EV_LOOKUP, np.arange(10, dtype=np.uint32), 0)
        r.record(j_kv.EV_INSERT, [3, 4], [0, 1])
        r.record(j_kv.EV_EVICT, np.arange(100, 110, dtype=np.uint32), 1)
    pa = recs[0].save(tmp_path / "ref.npz")
    pb = recs[1].save(tmp_path / "port.npz")
    assert j_corpus.validate_trace(pb) == []
    a, b = j_corpus.load_trace(pa), j_corpus.load_trace(pb)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    assert a[3] == b[3]


def _port_online(**kw):
    return t_gov.simulate_online(("p-bfs", "spmv", "p-bfs"), "Morpheus-ALL",
                                 length=12_000, epoch_len=1_500, seed=3,
                                 device="cpu", **kw)


def _stats_ints(s):
    return {f: int(np.asarray(getattr(s, f))) for f in s._fields
            if np.asarray(getattr(s, f)).dtype.kind == "i"}


def test_port_online_bit_identical_with_obs_on():
    base = _port_online()
    t_obs.enable(inspect=True)
    on = _port_online()
    tracer, reg = t_obs.tracer(), t_obs.metrics_registry()
    snaps = t_obs.inspector().snapshots
    t_obs.disable()
    assert [r.to_dict() for r in base.records] == \
        [r.to_dict() for r in on.records]
    assert [e.to_dict() for e in base.decisions] == \
        [e.to_dict() for e in on.decisions]
    assert (base.ipc, base.switches, _stats_ints(base.stats)) == \
        (on.ipc, on.switches, _stats_ints(on.stats))
    # the side channels saw the run
    assert len(snaps) == len(on.records)
    c = t_met.bench_counters(reg)
    assert c["dispatches"] == c["epochs"] == len(on.records)
    assert c["snapshots"] == len(on.records) and c["device_get_bytes"] > 0
    assert c["flush_writebacks"] == \
        sum(r.flush_writebacks for r in on.records)
    names = {e["name"] for e in tracer.events}
    assert {"online.replica", "online.pack", "online.advance",
            "online.consume", "governor.decide"} <= names
    instants = [e for e in tracer.events if e["name"] == "governor.decision"]
    assert len(instants) == len(on.decisions)


def test_port_online_decisions_match_reference_with_obs_on():
    """The reference and the port, both with every obs channel on, give
    the same decision stream and telemetry rows."""
    j_obs.enable(inspect=True)
    t_obs.enable(inspect=True)
    ref = j_gov.simulate_online(("p-bfs", "spmv", "p-bfs"), "Morpheus-ALL",
                                length=12_000, epoch_len=1_500, seed=3,
                                backend="jnp")
    port = _port_online()
    js, ts = j_obs.inspector().snapshots, t_obs.inspector().snapshots
    assert [e.to_dict() for e in ref.decisions] == \
        [e.to_dict() for e in port.decisions]
    assert [r.to_dict() for r in ref.records] == \
        [r.to_dict() for r in port.records]
    assert [s.to_dict() for s in js] == [s.to_dict() for s in ts]


def test_port_engine_and_pool_bit_identical_with_obs_on():
    cfg, pcfg = tp.small_cfg()
    trace = [(*tp.trace(n=700, seed=4), 50)]
    base = t_engine.simulate_batch(pcfg, trace, "cpu")
    state0 = t_engine.init_state(pcfg, 1, "cpu")
    pt = t_engine.pack(pcfg, trace)
    s_off, d_off = t_engine.advance_packed(pcfg, pt, state0, "cpu")
    keys = _demo_keys(seed=2)
    pool_cfg = t_kv.PoolConfig(conv_sets=8, ext_sets_per_chip=4,
                               num_cache_chips=2, ways=4)
    p_off = t_kv.MorpheusPagePool(pool_cfg, device="cpu")
    plans_off = [p_off.lookup_batch(b) for b in np.split(keys, 3)]
    t_obs.enable(inspect=True)
    on = t_engine.simulate_batch(pcfg, trace, "cpu")
    s_on, d_on = t_engine.advance_packed(pcfg, pt, state0, "cpu")
    p_on = t_kv.MorpheusPagePool(pool_cfg, device="cpu")
    plans_on = [p_on.lookup_batch(b) for b in np.split(keys, 3)]
    c = t_obs.bench_counters()
    t_obs.disable()
    for a, b in zip(base, on):
        assert torch.equal(a, b)
    for a, b in zip(d_off, d_on):
        assert torch.equal(a, b)
    for a, b in zip(s_off[:-2], s_on[:-2]):
        assert torch.equal(a, b)
    for a, b in zip(plans_off, plans_on):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert p_off.stats == p_on.stats
    assert c["dispatches"] == 2
    json.dumps(p_on.content_snapshot().to_dict())


def test_serving_engine_notes_owners_and_stays_identical():
    """With the inspector on, the port's serving engine notes each
    consulted page key's tenant, the pool's snapshot attributes every
    resident page to one, and tokens and pool stats match a run with
    obs off."""
    from repro_torch import configs
    from repro_torch.models import LM, seeded_numpy_params
    from repro_torch.serving import Engine, Request
    cfg = configs.get("qwen3-4b").reduced()
    weights = seeded_numpy_params(cfg, 0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 32).tolist()
               for _ in range(4)]

    def serve():
        eng = Engine(LM(cfg, device="cpu"), weights, max_len=48)
        reqs = [Request(i, p, 2, tenant="ab"[i % 2])
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        return eng, [r.out_tokens for r in reqs]

    base, base_tokens = serve()
    t_obs.enable(trace=False, metrics=False, inspect=True)
    eng, tokens = serve()
    owners = dict(t_obs.inspector().owners)
    t_obs.disable()
    assert tokens == base_tokens and eng.pool.stats == base.pool.stats
    assert sorted(set(owners.values())) == ["a", "b"]
    assert len(owners) == 2 * len(prompts)        # 2 pages a prompt
    snap = eng.pool.content_snapshot(owners=owners)
    assert set(snap.residency) <= {"a", "b"}
    assert sum(snap.residency.values()) == \
        sum(snap.conv_set_occ) + sum(snap.ext_set_occ) > 0
