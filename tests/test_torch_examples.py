"""The port's example twins (``examples/torch_*.py``) against the
reference's example scripts, each run in-process with the same inputs,
and the golden file of the replay and the quickstart that
``chip_smoke.py`` holds the card to.

  * ``torch_morpheus_replay``: best splits and integer Stats identical to
    the reference script's ``cache_sim.run`` results (recorded as it
    runs), normalized time, hit rate and MPKI within 1e-3 relative, the
    printed lines equal, for ``kmeans`` and ``cfd`` at a reduced length;
  * ``torch_quickstart``: pool stats equal, the simulator's times within
    1e-3 relative and its integer Stats identical, the train step's loss
    within 1e-5 on the reference script's own weights and tokens;
  * ``torch_serve_morpheus``: every printed line but the wall-clock
    fields equal (tokens, pages, governor decisions, SLO lines, pool
    stats) and every ``EngineReport`` identical, on reduced qwen3-4b with
    the reference script's weights, for ``--split auto``, ``--split 2``,
    ``--slo-ms`` and ``--workload`` with ``--arrival``;
  * ``torch_train_lm``: every loss of both calls within 1e-5 of the
    reference's on its weights, the same resume step.

``tests/data/torch_golden_examples.json`` holds the reference's replay
rows of ``kmeans`` and ``cfd`` at the default 30 000 requests and the
quickstart's pool stats and simulator runs; regenerate it with

    PYTHONPATH=src python tests/test_torch_examples.py      (~3 min)
"""
import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as j_configs  # noqa: E402
from repro.core import cache_sim as j_cs  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.core.controller import _INT_FIELDS  # noqa: E402
from repro_torch.serving import Engine as TEngine  # noqa: E402

from torch_parity import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "torch_golden_examples.json"
APPS = ("kmeans", "cfd")
REPLAY_LENGTH = 6_000          # the tests' reduced length
GOLDEN_LENGTH = 30_000         # the scripts' default, the golden's
RTOL = 1e-3                    # the engine's float contract
LOSS_TOL = 1e-5
WALL = re.compile(r" in \d+\.\d+s \(\d+\.\d+ tok/s\)")


def load(rel: str, name: str = None):
    """The script at ``rel`` as a module (its top level runs)."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        name or "_script_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(fn, argv=()) -> list:
    """The stdout lines of ``fn()`` with ``sys.argv`` set to ``argv``."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = ["prog", *argv]
    try:
        with contextlib.redirect_stdout(out):
            fn()
    finally:
        sys.argv = old
    return out.getvalue().splitlines()


def numpy_tree(params) -> dict:
    return jax.tree.map(np.asarray, params)


# ------------------------------------------------------------ replay

def result_row(r, base) -> dict:
    return {"n_compute": int(r.n_compute), "n_cache": int(r.n_cache),
            "norm_time": float(r.exec_time_s / base.exec_time_s),
            "hit_rate": float(r.llc_hit_rate), "mpki": float(r.mpki),
            "stats": {f: int(getattr(r.stats, f)) for f in _INT_FIELDS}}


def reference_replay(app: str, length: int, monkeypatch=None) -> tuple:
    """The reference script's lines and its rows, in the twin's layout,
    from the ``cache_sim.run`` results it makes (recorded in order: BL,
    the four systems, the three predictors)."""
    mod = load("examples/morpheus_replay.py")
    runs = []
    real = j_cs.run

    def record(*a, **kw):
        runs.append(real(*a, **kw))
        return runs[-1]
    with (monkeypatch.context() if monkeypatch else _patching()) as m:
        m.setattr(j_cs, "run", record)
        lines = printed(mod.main, ["--app", app, "--length", str(length)])
    base = runs[0]
    rows = dict(zip(mod.SYSTEMS, [result_row(r, base)
                                  for r in [base] + runs[1:5]]))
    ablation = dict(zip(("bloom", "none", "perfect"),
                        [result_row(r, base) for r in runs[5:8]]))
    return lines, {"rows": rows, "ablation": ablation}


@contextlib.contextmanager
def _patching():
    mp = pytest.MonkeyPatch()
    try:
        yield mp
    finally:
        mp.undo()


def rows_close(got: dict, want: dict, ctx: str) -> None:
    """Splits and integer Stats identical, floats within ``RTOL``."""
    for part in ("rows", "ablation"):
        assert list(got[part]) == list(want[part]), ctx
        for k, w in want[part].items():
            g = got[part][k]
            where = f"{ctx} {part} {k}"
            assert (g["n_compute"], g["n_cache"]) == \
                (w["n_compute"], w["n_cache"]), where
            assert g["stats"] == w["stats"], where
            for f in ("norm_time", "hit_rate", "mpki"):
                assert g[f] == pytest.approx(w[f], rel=RTOL), (where, f)


@pytest.mark.parametrize("app", APPS)
def test_replay_rows_equal_the_reference(app, monkeypatch):
    twin = load("examples/torch_morpheus_replay.py")
    lines, want = reference_replay(app, REPLAY_LENGTH, monkeypatch)
    results, real = [], twin.run
    monkeypatch.setattr(twin, "run", lambda *a, **kw: results.append(
        real(*a, **kw)) or results[-1])
    assert printed(lambda: twin.main(["--app", app, "--length",
                                      str(REPLAY_LENGTH), "--device",
                                      "cpu"])) == lines
    rows_close(results[0], want, app)


def test_replay_golden_holds_the_scripts_default_length():
    """The golden file's shape: both apps at 30 000 requests, five
    systems and three predictors each, integer Stats; the quickstart's
    pool stats and two simulator runs."""
    g = json.loads(GOLDEN.read_text())
    assert g["replay_length"] == GOLDEN_LENGTH
    for app in APPS:
        cell = g["replay"][app]
        assert list(cell["rows"]) == ["BL", "IBL", "IBL-4x-LLC",
                                      "Morpheus-Basic", "Morpheus-ALL"]
        assert list(cell["ablation"]) == ["bloom", "none", "perfect"]
        assert set(cell["rows"]["BL"]["stats"]) == set(_INT_FIELDS)
    assert set(g["quickstart"]["sim"]) == {"BL", "Morpheus-ALL"}
    pool = g["quickstart"]["pool"]
    assert pool["conv_hits"] + pool["conv_misses"] > 0


# ------------------------------------------------------------ quickstart

@pytest.fixture(scope="module")
def quickstart_ref():
    """The reference quickstart, run at import in this process: its lines
    and globals (pool stats, weights, tokens, metrics, runs)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod = load("examples/quickstart.py")
    return out.getvalue().splitlines(), mod


def test_quickstart_equals_the_reference(quickstart_ref):
    lines, ref = quickstart_ref
    twin = load("examples/torch_quickstart.py")
    got = twin.run(device="cpu", params=numpy_tree(ref.params),
                   tokens=np.asarray(ref.tokens))
    assert got["pool"] == dict(ref.s._asdict())
    assert abs(got["model"]["loss"] - float(ref.metrics["loss"])) <= LOSS_TOL
    for name, r in (("BL", ref.bl), ("Morpheus-ALL", ref.mo)):
        g = got["sim"][name]
        assert g["stats"] == {f: int(getattr(r.stats, f))
                              for f in _INT_FIELDS}
        assert g["exec_time_s"] == pytest.approx(r.exec_time_s, rel=RTOL)
    want = [ln for ln in lines if "train step: loss" not in ln]
    assert [ln for ln in twin.lines(got)
            if "train step: loss" not in ln] == want


# ------------------------------------------------------------ serving

SERVE_MODES = {
    "auto": ["--split", "auto"],
    "split2": ["--split", "2"],
    "slo": ["--split", "auto", "--workload", "tenantA,tenantB",
            "--slo-ms", "2.5"],
    "arrival": ["--split", "auto", "--rounds", "5", "--workload",
                "tenantA,tenantB", "--arrival", "onoff:6,0.5,0.5"],
}


@pytest.fixture(scope="module")
def serve_params():
    cfg = j_configs.get("qwen3-4b").reduced()
    return numpy_tree(j_build_model(cfg).init(jax.random.PRNGKey(0)))


def report_of(rep) -> dict:
    return dataclasses.asdict(rep)


@pytest.mark.parametrize("mode", list(SERVE_MODES))
def test_serve_equals_the_reference(mode, serve_params, monkeypatch):
    """The reference script and the twin's CLI on the same weights: the
    lines but their wall-clock fields, and every ``EngineReport`` (the
    rounds', then the transparency check's two)."""
    ref = load("examples/serve_morpheus.py")
    twin = load("examples/torch_serve_morpheus.py")
    reports = {"ref": [], "port": []}
    for k, cls in (("ref", JEngine), ("port", TEngine)):
        def record(self, reqs, _real=cls.run, _k=k):
            rep = _real(self, reqs)
            reports[_k].append(report_of(rep))
            return rep
        monkeypatch.setattr(cls, "run", record)
    built = twin.build
    monkeypatch.setattr(twin, "build", lambda cfg, device=None, params=None:
                        built(cfg, device, serve_params))
    argv = SERVE_MODES[mode]
    want = printed(ref.main, argv)
    got = printed(lambda: twin.main([*argv, "--device", "cpu"]))
    assert [WALL.sub("", ln) for ln in got] == \
        [WALL.sub("", ln) for ln in want]
    assert len(reports["port"]) == len(reports["ref"]) > 2
    for g, w in zip(reports["port"], reports["ref"]):
        assert {k: v for k, v in g.items() if k != "modeled_time_ns"} == \
            {k: v for k, v in w.items() if k != "modeled_time_ns"}
        assert g["modeled_time_ns"] == pytest.approx(w["modeled_time_ns"],
                                                     rel=1e-6)


def test_serve_run_returns_what_it_prints(serve_params):
    """``run`` on any config: its rounds' reports and tokens, governor
    records and the transparency check, the lines through ``log``."""
    twin = load("examples/torch_serve_morpheus.py")
    lines = []
    out = twin.run(t_configs.get("qwen3-4b").reduced(), split="auto",
                   rounds=2, device="cpu", params=serve_params,
                   log=lines.append)
    assert out["match"] and out["tokens_on"] == out["tokens_off"]
    assert [r["tag"] for r in out["rounds"]] == ["cold", "warm1"]
    assert len(out["ticks"]) == 2
    assert out["rounds"][0]["report"]["generated"] == 32
    assert lines[-1] == "tokens identical with/without Morpheus tier: True"


# ------------------------------------------------------------ training

TRAIN_ARGV = ["--steps", "12"]


def test_train_lm_equals_the_reference(tmp_path, monkeypatch):
    """12 steps with checkpoints, then the restart: every loss of both
    calls within 1e-5 of the reference's, on the reference's initial
    weights (``PRNGKey(0)``), and the same resume step and steps run."""
    ref = load("examples/train_lm.py")
    twin = load("examples/torch_train_lm.py")
    calls = {"ref": [], "port": []}
    cfg = j_configs.get("qwen3-4b").reduced()
    init = numpy_tree(j_build_model(cfg).init(jax.random.PRNGKey(0)))
    for k, mod in (("ref", ref), ("port", twin)):
        def record(*a, _real=mod.train, _k=k, **kw):
            out = _real(*a, **kw)
            calls[_k].append(out)
            return out
        monkeypatch.setattr(mod, "train", record)
    monkeypatch.setattr(twin, "run", functools.partial(twin.run, init=init))
    want = printed(ref.main, [*TRAIN_ARGV, "--ckpt-dir",
                              str(tmp_path / "ref")])
    got = printed(lambda: twin.main([*TRAIN_ARGV, "--ckpt-dir",
                                     str(tmp_path / "port"), "--device",
                                     "cpu"]))
    assert len(calls["port"]) == len(calls["ref"]) == 2
    for (_, gl, grep), (_, wl, wrep) in zip(calls["port"], calls["ref"]):
        np.testing.assert_allclose(gl, wl, rtol=0, atol=LOSS_TOL)
        assert (grep.resumed_from, grep.steps_run) == \
            (wrep.resumed_from, wrep.steps_run)
    assert calls["port"][1][2].resumed_from == 12
    strip = lambda ls: [ln for ln in ls if "ckpt ->" not in ln]  # noqa
    assert len(strip(got)) == len(strip(want))
    assert got[-1].startswith("resumed at step 12 and ran 5 more steps")


def test_train_lm_builds_the_references_configs():
    """``build_cfg`` of the twin gives the reference's config for the
    defaults, ``--model-100m`` and ``--full``, field by field."""
    ref = load("examples/train_lm.py")
    twin = load("examples/torch_train_lm.py")
    for flags in ([], ["--model-100m"], ["--full"],
                  ["--arch", "mamba2-780m", "--model-100m"]):
        ns = lambda: type("A", (), dict(  # noqa: E731
            arch=flags[flags.index("--arch") + 1] if "--arch" in flags
            else "qwen3-4b", full="--full" in flags,
            model_100m="--model-100m" in flags))
        a, b = ref.build_cfg(ns()), twin.build_cfg(ns())
        assert dataclasses.asdict(a) == dataclasses.asdict(b), flags


# ------------------------------------------------------------ the golden

def write_golden() -> None:
    """The reference's replay rows (both apps, the default length) and
    its quickstart's pool stats and simulator runs."""
    out = {"replay_length": GOLDEN_LENGTH, "replay": {}}
    for app in APPS:
        lines, rows = reference_replay(app, GOLDEN_LENGTH)
        out["replay"][app] = dict(rows, lines=lines)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        qs = load("examples/quickstart.py")
    out["quickstart"] = {
        "pool": {k: int(v) if isinstance(v, (int, np.integer)) else float(v)
                 for k, v in qs.s._asdict().items()},
        "sim": {name: {"exec_time_s": float(r.exec_time_s),
                       "hit_rate": float(r.llc_hit_rate),
                       "mpki": float(r.mpki),
                       "stats": {f: int(getattr(r.stats, f))
                                 for f in _INT_FIELDS}}
                for name, r in (("BL", qs.bl), ("Morpheus-ALL", qs.mo))}}
    GOLDEN.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    write_golden()
