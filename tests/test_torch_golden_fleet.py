"""Golden results of the reference's fleet runtime, admission control and
autotuner (``backend="jnp"``), kept in tests/data/torch_golden_fleet.json,
which the port's chip check (``chip_smoke.py`` phase 15) holds the card
to.

The cells are those of the reference's figure scripts:

  * ``fleet``: ``benchmarks/fig_fleet.py``'s ``full`` profile, 64
    replicas cycling ``("cfd", "stencil", "p-bfs", "kmeans")``,
    Morpheus-ALL, 48 000 requests, epochs of 3 000, seed i, each on
    ``candidates_for(app, grid=(18, 32, 48, 68), length=48 000)``;
  * ``overload``: ``benchmarks/fig_overload.py``'s ``full`` profile at
    load 8.0: base 128, 36 rounds, tenants hi/mid/lo (cfd/kmeans/histo),
    SLOs from the calibration run (a fixed-split 1x run at (32, 36), 6
    rounds), with ``AdmissionConfig()`` and with ``admission=None``; and
    the admission-event CRCs of the four canonical scenarios of
    tests/scenarios.py;
  * ``autotune``: ``benchmarks/fig_autotune.py``'s ``quick`` budgets:
    ``GovernorObjective`` on the two quick cells (60 000 requests) with a
    GA (seed 0, pop 4, 3 generations), and ``HardwareObjective("cfd")``
    (12 000 requests) over ``hw_space()`` with a hill climb (seed 0, pop
    5, 4 generations).

This test checks the file's header and cell parameters against the
definitions here, its internal consistency, and replays fleet replicas
0-3 (a prefix fleet, which the fleet's batching invariance makes equal to
the 64-replica fleet's first rows) and the overload pair through the
port's plain path on the CPU.

Regenerate the file with
``PYTHONPATH=src python tests/test_torch_golden_fleet.py`` (minutes on one
CPU: the reference's 64-replica fleet on jnp).
"""
import json
import sys
import zlib
from pathlib import Path

import jax  # noqa: F401  (both packages in one process, data as numpy)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import controller as j_ctl  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_golden_fleet.json"
SOURCE = ("repro.runtime.fleet / admission and repro.autotune, backend "
          "jnp: fig_fleet full, fig_overload full at load 8, fig_autotune "
          "quick")
SYSTEM = "Morpheus-ALL"
FLEET = {"apps": ["cfd", "stencil", "p-bfs", "kmeans"], "replicas": 64,
         "length": 48_000, "epoch_len": 3_000,
         "ladder_grid": [18, 32, 48, 68]}
OVERLOAD = {"base": 128, "rounds": 36, "load": 8.0, "seed": 7,
            "headroom": 0.85, "slo_mult": {"hi": 1.35, "mid": 2.7,
                                           "lo": 5.4},
            "tenants": [["hi", 2.0, 2, "cfd"], ["mid", 1.0, 1, "kmeans"],
                        ["lo", 1.0, 0, "histo"]],
            "ladder": [[18, 50], [32, 36], [48, 20], [68, 0]],
            "calibration": {"rounds": 6, "split": [32, 36]}}
AUTOTUNE = {"gov": {"cells": [["cfd,kmeans", "det:2e6"],
                              ["cfd,kmeans", "mmpp:4e5,6e6,2e-3,6e-4"]],
                    "length": 60_000, "agent": "ga", "seed": 0, "pop": 4,
                    "generations": 3},
            "hw": {"app": "cfd", "length": 12_000, "agent": "hill",
                   "seed": 0, "pop": 5, "generations": 4}}
FLOAT_RTOL = 1e-3


# ------------------------------------------------------------ the cells

def fleet_specs(fleet_mod, governor, n: int, seed0: int = 0):
    """fig_fleet's ``_specs``: replica i serves ``apps[i % 4]`` with seed
    ``seed0 + i`` on its app's ladder."""
    apps = FLEET["apps"]
    ladders = {a: governor.candidates_for(
        a, SYSTEM, grid=tuple(FLEET["ladder_grid"]), length=FLEET["length"])
        for a in apps}
    return [fleet_mod.ReplicaSpec(apps[i % len(apps)], SYSTEM,
                                  length=FLEET["length"],
                                  epoch_len=FLEET["epoch_len"],
                                  seed=seed0 + i,
                                  candidates=ladders[apps[i % len(apps)]],
                                  name=f"r{i}:{apps[i % len(apps)]}")
            for i in range(n)]


def replica_record(r) -> dict:
    """The golden record of one replica's run."""
    return {"splits": [[x.n_compute, x.n_cache] for x in r.records],
            "decisions": [d.compact() for d in r.decisions],
            "switches": int(r.switches),
            "int_stats": {f: int(np.asarray(getattr(r.stats, f)))
                          for f in j_ctl._INT_FIELDS},
            "float_stats": {f: float(np.asarray(getattr(r.stats, f)))
                            for f in r.stats._fields
                            if f not in j_ctl._INT_FIELDS},
            "ipc": float(r.ipc),
            "rewards": [float(x.reward) for x in r.records]}


def overload_tenants(serving, base_ms: float):
    return [serving.TenantSLO(name, OVERLOAD["slo_mult"][name] * base_ms,
                              weight=w, priority=p, app=app)
            for name, w, p, app in OVERLOAD["tenants"]]


def overload_run(admission, overload, serving, mode, **device):
    """(calibrated base ms, result) of one overload cell, as
    fig_overload's ``_calibrate`` and ``_run_cell`` run it."""
    base, seed = OVERLOAD["base"], OVERLOAD["seed"]
    cal = OVERLOAD["calibration"]
    tenants = overload_tenants(serving, 1.0)
    scn = overload.LoadScenario("calibrate", "sustained", 1.0,
                                rounds=cal["rounds"], seed=seed)
    res = admission.simulate_overload(
        tenants, overload.demand_schedule(scn, tenants, base), system=SYSTEM,
        admission=None, fixed_split=tuple(cal["split"]), seed=seed,
        budgeter=serving.TenantSLOBudgeter(tenants, min_total=base,
                                           max_total=8 * base,
                                           initial_total=8 * base),
        **device)
    base_ms = float(np.mean([r["round_ms"] for r in res.rounds
                             if not r.get("idle")]))
    tenants = overload_tenants(serving, base_ms)
    load = OVERLOAD["load"]
    scn = overload.LoadScenario(f"sustained{load:g}", "sustained", load,
                                rounds=OVERLOAD["rounds"], seed=seed)
    budgeter = serving.TenantSLOBudgeter(
        tenants, min_total=4, max_total=8 * base, initial_total=base,
        headroom=OVERLOAD["headroom"])
    cfg = admission.AdmissionConfig() if mode == "admission" else None
    return base_ms, admission.simulate_overload(
        tenants, overload.demand_schedule(scn, tenants, base), system=SYSTEM,
        admission=cfg, budgeter=budgeter,
        candidates=[tuple(c) for c in OVERLOAD["ladder"]], seed=seed,
        **device)


def overload_record(res) -> dict:
    ints = j_ctl._INT_FIELDS
    return {"rounds": [[r.get("served", {}), r.get("deferred", {}),
                        r.get("shed", {}), list(r["split"])]
                       for r in res.rounds],
            "events_crc": zlib.crc32(";".join(
                e.compact() for e in res.events).encode()) & 0xFFFFFFFF,
            "events": len(res.events),
            "decisions": [d.compact() for d in res.decisions],
            "int_stats": {f: int(np.asarray(getattr(res.stats, f)))
                          for f in ints},
            "tenant_int_stats": {
                n: {f: int(np.asarray(getattr(s, f))) for f in ints}
                for n, s in res.tenant_stats.items()},
            "offered": res.offered, "served": res.served, "shed": res.shed,
            "backlog": res.backlog}


def autotune_searches(at, tmp_dir: Path, **device) -> dict:
    """The two quick-budget searches; per search its generations' keys
    and scores, best config and score (and the governor cells' best
    static IPCs)."""
    out = {}
    g = AUTOTUNE["gov"]
    obj = at.GovernorObjective([tuple(c) for c in g["cells"]],
                               length=g["length"], **device)
    out["gov"] = _search(at, at.gov_space(), obj, g, tmp_dir / "gov.jsonl")
    out["gov"]["best_static_ipcs"] = list(obj.best_static_ipcs())
    h = AUTOTUNE["hw"]
    obj = at.HardwareObjective(h["app"], length=h["length"],
                               **({"device": device["device"]}
                                  if "device" in device else {}))
    out["hw"] = _search(at, at.hw_space(), obj, h, tmp_dir / "hw.jsonl")
    return out


def _search(at, space, obj, spec: dict, path: Path) -> dict:
    res = at.Tuner(space, obj, at.make_agent(spec["agent"], space,
                                             seed=spec["seed"],
                                             pop=spec["pop"]),
                   trajectory_path=path).run(spec["generations"])
    doc = at.read_trajectory(path)
    return {"keys": [g["keys"] for g in doc["generations"]],
            "scores": [g["scores"] for g in doc["generations"]],
            "best_config": res.best_config, "best_score": res.best_score,
            "dispatches": obj.dispatches}


def scenario_record(scenarios) -> dict:
    """tests/scenarios.py's canonical tenant set, round sizes and
    admission-event CRCs, for a check that imports neither package."""
    return {"tenants": [[t.name, t.slo_ms, t.weight, t.priority, t.app]
                        for t in scenarios.TENANTS],
            "base_total": scenarios.BASE_TOTAL,
            "capacity": scenarios.CAPACITY,
            "crcs": {name: scenarios.event_crc(
                scenarios.run_controller(scn)[0])
                for name, scn in sorted(scenarios.SCENARIOS.items())}}


def reference_golden(tmp_dir: Path) -> dict:
    import repro.autotune as at
    from repro.runtime import admission, fleet, governor
    from repro.workloads import overload, serving
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import scenarios
    fr = fleet.simulate_fleet(fleet_specs(fleet, governor,
                                          FLEET["replicas"]),
                              backend="jnp")
    over = {}
    for mode in ("admission", "none"):
        base_ms, res = overload_run(admission, overload, serving, mode,
                                    backend="jnp")
        over[mode] = overload_record(res)
    return {
        "source": SOURCE, "system": SYSTEM,
        "fleet": {**FLEET, "epochs": fr.epochs,
                  "dispatches": fr.dispatches, "names": fr.names,
                  "replicas_results": [replica_record(r)
                                       for r in fr.results]},
        "overload": {**OVERLOAD, "base_ms": base_ms, **over,
                     "scenarios": scenario_record(scenarios)},
        "autotune": {**AUTOTUNE,
                     **{k: {**AUTOTUNE[k], **v} for k, v in
                        autotune_searches(at, tmp_dir,
                                          backend="jnp").items()}}}


# ---------------------------------------------------------------- tests

def _golden() -> dict:
    return json.loads(GOLDEN.read_text())


def test_golden_fleet_file_header_and_consistency():
    g = _golden()
    assert (g["source"], g["system"]) == (SOURCE, SYSTEM)
    assert {k: g["fleet"][k] for k in FLEET} == FLEET
    assert {k: g["overload"][k] for k in OVERLOAD} == OVERLOAD
    for k in ("gov", "hw"):
        assert {f: g["autotune"][k][f] for f in AUTOTUNE[k]} == AUTOTUNE[k]
    fl = g["fleet"]
    reps = fl["replicas_results"]
    assert len(reps) == len(fl["names"]) == FLEET["replicas"]
    n_epochs = FLEET["length"] // FLEET["epoch_len"]
    assert fl["epochs"] == n_epochs
    # one dispatch per distinct split a step, at least one a step
    assert n_epochs <= fl["dispatches"] <= n_epochs * 4
    for r in reps:
        assert len(r["splits"]) == len(r["rewards"]) == n_epochs
        assert r["switches"] >= sum(a != b for a, b in
                                    zip(r["splits"], r["splits"][1:]))
    steps = [len({tuple(r["splits"][e]) for r in reps})
             for e in range(n_epochs)]
    assert fl["dispatches"] == sum(steps)
    for mode in ("admission", "none"):
        o = g["overload"][mode]
        assert len(o["rounds"]) == OVERLOAD["rounds"]
        for f, v in o["int_stats"].items():
            if f in ("conv_hits", "conv_misses", "ext_hits",
                     "ext_true_miss"):
                assert sum(t[f] for t in o["tenant_int_stats"].values()) \
                    == v, f
        for n in o["offered"]:
            assert o["offered"][n] == o["served"][n] + o["shed"][n] + \
                o["backlog"][n]
    assert g["overload"]["none"]["events"] == 0
    assert sum(g["overload"]["admission"]["shed"].values()) > 0
    import scenarios
    assert g["overload"]["scenarios"] == json.loads(json.dumps(
        scenario_record(scenarios)))
    assert g["overload"]["scenarios"]["crcs"] == scenarios.GOLDEN_CRC
    for k in ("gov", "hw"):
        a = g["autotune"][k]
        assert len(a["keys"]) == len(a["scores"]) == a["generations"]
        assert a["dispatches"] == a["generations"]
        assert a["best_score"] == max(max(s) for s in a["scores"])


def _assert_replica(got: dict, want: dict, ctx: str):
    for key in ("splits", "decisions", "switches", "int_stats"):
        assert got[key] == want[key], f"{ctx}: {key}"
    for f, w in want["float_stats"].items():
        assert abs(got["float_stats"][f] - w) <= FLOAT_RTOL * max(abs(w),
                                                                  1.0), f
    assert abs(got["ipc"] - want["ipc"]) <= FLOAT_RTOL * want["ipc"]
    for a, b in zip(got["rewards"], want["rewards"]):
        assert abs(a - b) <= FLOAT_RTOL * max(abs(b), 1.0), ctx


def test_port_fleet_replicas_0_to_3_match_golden():
    from repro_torch.runtime import fleet, governor
    g = _golden()["fleet"]
    fr = fleet.simulate_fleet(fleet_specs(fleet, governor, 4),
                              device="cpu")
    assert fr.names == g["names"][:4]
    for i, r in enumerate(fr.results):
        _assert_replica(replica_record(r), g["replicas_results"][i],
                        f"replica {i}")


@pytest.mark.parametrize("mode", ["admission", "none"])
def test_port_overload_pair_matches_golden(mode):
    from repro_torch.runtime import admission
    from repro_torch.workloads import overload, serving
    g = _golden()["overload"]
    base_ms, res = overload_run(admission, overload, serving, mode,
                                device="cpu")
    assert abs(base_ms - g["base_ms"]) <= FLOAT_RTOL * g["base_ms"]
    got = overload_record(res)
    for key, want in g[mode].items():
        assert got[key] == want, key
    assert res.attribution_exact()


if __name__ == "__main__":
    import tempfile
    torch.set_num_threads(1)
    GOLDEN.parent.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory() as d:
        doc = reference_golden(Path(d))
    GOLDEN.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
