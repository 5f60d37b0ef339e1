"""The port's autotuner (``repro_torch.autotune``) against the
reference's (``repro.autotune``) on the CPU.

``space``, ``agents`` and ``tuner`` are numpy copies: the same seed gives
the same proposals and the same trajectory bytes (the golden
Synth-objective script of tests/test_autotune.py gives CRC 4171697855 on
the port too), with the same resume and tamper checks.  The objectives
run the port's engine: each generation's configs are the reference's,
scores within 1e-3 relative, one batched engine call a generation."""
import subprocess
import sys
import zlib
from pathlib import Path

import jax  # noqa: F401  (both packages in one process, data as numpy)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import one_torch_thread  # noqa: E402,F401
import repro.autotune as j_at  # noqa: E402
import repro_torch.autotune as t_at  # noqa: E402
from repro_torch.core import cache_sim as t_cs  # noqa: E402
from repro_torch.runtime import fleet as t_fleet  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GOLDEN_CRC = 4171697855       # tests/test_autotune.py
RTOL = 1e-3


def _space(at):
    return at.SearchSpace([at.Knob("a", (1, 2, 3)), at.Knob("b", (0.1, 0.2)),
                           at.Knob("c", ("x", "y", "z"))])


class Synth:
    """tests/test_autotune.py's deterministic separable objective."""
    name = "synth"

    def __init__(self, space):
        self.space = space
        self.dispatches = 0

    def evaluate(self, configs):
        self.dispatches += 1
        return [-sum((2 * i - 3) ** 2 for i in self.space.encode(c))
                for c in configs]

    def describe(self):
        return {"objective": "synth"}


@pytest.mark.parametrize("name", sorted(j_at.AGENTS))
def test_agent_proposals_equal_reference(name):
    assert sorted(t_at.AGENTS) == sorted(j_at.AGENTS)
    spaces = {"port": _space(t_at), "ref": _space(j_at)}
    agents = {"port": t_at.make_agent(name, spaces["port"], seed=11, pop=4),
              "ref": j_at.make_agent(name, spaces["ref"], seed=11, pop=4)}
    obj = Synth(spaces["ref"])
    for _ in range(5):
        props = {k: a.propose() for k, a in agents.items()}
        assert props["port"] == props["ref"]
        scores = obj.evaluate(props["ref"])
        for k, a in agents.items():
            a.observe(props[k], scores)
    assert agents["port"].best == agents["ref"].best


@pytest.mark.parametrize("space_fn", ["gov_space", "hw_space"])
def test_spaces_and_samples_equal_reference(space_fn):
    p, r = getattr(t_at, space_fn)(), getattr(j_at, space_fn)()
    assert p.describe() == r.describe() and p.size == r.size
    rp, rr = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(10):
        a, b = p.sample(rp), r.sample(rr)
        assert a == b and p.mutate(a, rp) == r.mutate(b, rr)


@pytest.mark.parametrize("agent", sorted(j_at.AGENTS))
def test_trajectory_bytes_equal_reference(tmp_path, agent):
    paths = {}
    for k, at in (("port", t_at), ("ref", j_at)):
        s = at.gov_space()
        paths[k] = tmp_path / f"{k}.jsonl"
        at.Tuner(s, Synth(s), at.make_agent(agent, s, seed=0, pop=5),
                 trajectory_path=paths[k]).run(6)
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()
    assert t_at.trajectory_crc(paths["port"]) == \
        j_at.trajectory_crc(paths["ref"])


_GOLDEN = r"""
import sys
from repro_torch.autotune import Tuner, gov_space, make_agent

class Synth:
    name = "synth"
    def evaluate(self, configs):
        return [-sum((2 * i - 3) ** 2 for i in SPACE.encode(c))
                for c in configs]
    def describe(self):
        return {"objective": "synth"}

SPACE = gov_space()
Tuner(SPACE, Synth(), make_agent("ga", SPACE, seed=0, pop=5),
      trajectory_path=sys.argv[1]).run(6)
"""


def test_trajectory_golden_crc_from_a_fresh_process(tmp_path):
    """tests/test_autotune.py's golden script on ``repro_torch`` in a
    fresh interpreter gives the pinned CRC."""
    path = tmp_path / "run.jsonl"
    subprocess.run([sys.executable, "-c", _GOLDEN, str(path)], check=True,
                   env={"PYTHONPATH": str(ROOT / "src"),
                        "PATH": "/usr/bin:/bin"}, cwd=tmp_path)
    assert zlib.crc32(path.read_bytes()) == GOLDEN_CRC


def test_port_tuner_resume_is_byte_identical(tmp_path):
    s = _space(t_at)
    full, part = tmp_path / "full.jsonl", tmp_path / "part.jsonl"
    t_at.Tuner(s, Synth(s), t_at.make_agent("ga", s, seed=5, pop=4),
               trajectory_path=full).run(6)
    t_at.Tuner(s, Synth(s), t_at.make_agent("ga", s, seed=5, pop=4),
               trajectory_path=part).run(3)
    obj = Synth(s)
    res = t_at.Tuner(s, obj, t_at.make_agent("ga", s, seed=5, pop=4),
                     trajectory_path=part).run(6, resume=True)
    assert res.replayed == 3 and obj.dispatches == 3
    assert part.read_bytes() == full.read_bytes()


def test_port_resume_and_replay_refuse_foreign_or_tampered(tmp_path):
    import json
    s = _space(t_at)
    traj = tmp_path / "t.jsonl"
    t_at.Tuner(s, Synth(s), t_at.make_agent("hill", s, seed=0, pop=4),
               trajectory_path=traj).run(2)
    with pytest.raises(t_at.TrajectoryError, match="header mismatch"):
        t_at.Tuner(s, Synth(s), t_at.make_agent("hill", s, seed=1, pop=4),
                   trajectory_path=traj).run(4, resume=True)
    # a trajectory of the reference replays on the port, then tampering
    # is caught
    rs = _space(j_at)
    j_at.Tuner(rs, Synth(rs), j_at.make_agent("random", rs, seed=0, pop=3),
               trajectory_path=traj).run(3)
    assert t_at.replay_agent(traj).generation == 3
    lines = traj.read_text().splitlines()
    rec = json.loads(lines[1])
    rec["keys"][0][0] = (rec["keys"][0][0] + 1) % 3
    lines[1] = json.dumps(rec, sort_keys=True, separators=(",", ":"))
    traj.write_text("\n".join(lines) + "\n")
    with pytest.raises(t_at.TrajectoryError, match="verify failed"):
        t_at.replay_agent(traj)


def test_to_run_points_equal_reference():
    for cfgd in ({"n_compute": 32, "ext_ways": 16, "compression": True},
                 {"n_compute": 68, "ext_ways": 16, "compression": False}):
        kw = dict(app="cfd", system="Morpheus-ALL", length=8_000)
        p, r = t_at.to_run_points(cfgd, **kw), j_at.to_run_points(cfgd, **kw)
        assert [(x.n_compute, x.n_cache, x.overrides) for x in p] == \
            [(x.n_compute, x.n_cache, x.overrides) for x in r]


# ------------------------------------------------------- objectives

def _tune(at, space, obj, agent, gens, pop, tmp_path, tag):
    path = tmp_path / f"{tag}.jsonl"
    res = at.Tuner(space, obj, at.make_agent(agent, space, seed=0, pop=pop),
                   trajectory_path=path).run(gens)
    return res, at.read_trajectory(path)


def _assert_same_search(port, ref):
    (pres, pdoc), (rres, rdoc) = port, ref
    assert pdoc["header"] == rdoc["header"]
    assert len(pdoc["generations"]) == len(rdoc["generations"])
    for pg, rg in zip(pdoc["generations"], rdoc["generations"]):
        assert pg["keys"] == rg["keys"]
        for a, b in zip(pg["scores"], rg["scores"]):
            assert abs(a - b) <= RTOL * max(abs(b), 1.0)
    assert pres.best_config == rres.best_config


def test_hardware_objective_search_matches_reference(tmp_path, monkeypatch):
    calls = []
    real = t_cs.run_batch

    def counting(points, device=None):
        calls.append(len(points))
        return real(points, device)

    monkeypatch.setattr(t_cs, "run_batch", counting)
    out = {}
    for k, at, dev in (("port", t_at, dict(device="cpu")), ("ref", j_at, {})):
        space = at.hw_space(splits=(32, 48), ext_ways=(16, 32))
        obj = at.HardwareObjective("cfd", length=4_000, **dev)
        out[k] = _tune(at, space, obj, "hill", 3, 3, tmp_path, k)
        assert obj.dispatches == 3
    _assert_same_search(out["port"], out["ref"])
    assert len(calls) == 3 and all(n <= 3 for n in calls)


def test_hardware_objective_exhaustive_matches_reference():
    truth = {}
    for k, at, dev in (("port", t_at, dict(device="cpu")), ("ref", j_at, {})):
        space = at.hw_space(splits=(32, 68), ext_ways=(16,))
        obj = at.HardwareObjective("kmeans", length=3_000, **dev)
        truth[k] = obj.exhaustive(space)
        assert obj.dispatches == 0
    assert truth["port"].keys() == truth["ref"].keys()
    for key, v in truth["ref"].items():
        if v == float("-inf"):
            assert truth["port"][key] == v
        else:
            assert abs(truth["port"][key] - v) <= RTOL * abs(v)


def test_governor_objective_search_matches_reference(tmp_path, monkeypatch):
    """One fleet run a generation plus one for the static sweep; the
    reference's configs, scores within 1e-3."""
    calls = []
    real = t_fleet.simulate_fleet

    def counting(specs, **kw):
        calls.append(len(list(specs)))
        return real(specs, **kw)

    monkeypatch.setattr(t_fleet, "simulate_fleet", counting)
    out, best = {}, {}
    for k, at, dev in (("port", t_at, dict(device="cpu")),
                       ("ref", j_at, dict(backend="jnp"))):
        obj = at.GovernorObjective([("cfd", "det:2e6")], length=9_000,
                                   target_epoch=3_000, ladder_grid=(32, 48),
                                   **dev)
        out[k] = _tune(at, at.gov_space(), obj, "random", 2, 2, tmp_path, k)
        best[k] = obj.best_static_ipcs()
        assert obj.dispatches == 2
    assert calls == [3, 2, 2], calls
    _assert_same_search(out["port"], out["ref"])
    assert all(abs(a - b) <= RTOL * b for a, b in zip(best["port"],
                                                      best["ref"]))
