"""The port's tool twins (``tools/torch_trace_corpus.py``,
``tools/torch_autotune_trajectory.py``, ``tools/torch_profile_cell.py``)
against the reference's tools, each run in-process on the same files,
and the rule that no entry-script twin (``examples/torch_*.py``,
``tools/torch_*.py``) imports JAX or the reference package.

Files one package writes, the other's tool reads with the same printed
output; the corpus files of both exports are equal array for array, and
the trajectories byte for byte.  The profiler's totals are
``op_cost.analyze``'s."""
import ast
import contextlib
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.autotune as j_at  # noqa: E402
import repro_torch.autotune as t_at  # noqa: E402
from repro_torch.core import cache_sim as t_cs  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.roofline import op_cost  # noqa: E402

from torch_parity import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
TWINS = sorted(ROOT.glob("examples/torch_*.py")) + sorted(
    ROOT.glob("tools/torch_*.py"))
NEW_TWINS = ("examples/torch_morpheus_replay.py", "examples/torch_quickstart.py",
             "examples/torch_serve_morpheus.py", "examples/torch_train_lm.py",
             "tools/torch_trace_corpus.py",
             "tools/torch_autotune_trajectory.py",
             "tools/torch_profile_cell.py")


def load(rel: str):
    """The script at ``rel`` (from the repo's root) as a module, by path."""
    path = ROOT / rel
    name = "_script_" + path.stem
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(main, argv) -> tuple:
    """(exit code, stdout lines) of ``main(argv)`` with ``sys.argv`` set
    too (the reference's mains parse it)."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = ["prog", *argv]
    try:
        with contextlib.redirect_stdout(out):
            try:
                code = main(argv) if _takes_argv(main) else main()
            except SystemExit as e:
                code = e.code
    finally:
        sys.argv = old
    return code or 0, out.getvalue().splitlines()


def _takes_argv(main) -> bool:
    return main.__code__.co_argcount > 0


@pytest.fixture(scope="module")
def tools():
    return {k: (load(f"tools/{k}.py"), load(f"tools/torch_{k}.py"))
            for k in ("trace_corpus", "autotune_trajectory")}


# ------------------------------------------------------------ no JAX

@pytest.mark.parametrize("rel", NEW_TWINS)
def test_twin_imports_neither_jax_nor_the_reference(rel):
    """No import statement of the twin names ``jax`` or ``repro``."""
    tree = ast.parse((ROOT / rel).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "repro")]
    assert not bad, (rel, bad)
    assert (ROOT / rel) in TWINS


def test_twins_load_without_jax_in_a_fresh_process():
    """Loading every twin (and so the port modules each imports) leaves
    ``jax`` and ``repro`` out of ``sys.modules``."""
    code = ("import importlib.util, sys\n"
            "for i, p in enumerate(sys.argv[1:]):\n"
            "    s = importlib.util.spec_from_file_location(f'm{i}', p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "bad = [m for m in ('jax', 'repro') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code,
                    *[str(ROOT / r) for r in NEW_TWINS]], check=True,
                   env={"PYTHONPATH": str(ROOT / "src"),
                        "PATH": "/usr/bin:/bin"}, timeout=300)


# ------------------------------------------------------------ corpus

EXPORTS = [["cfd", "--length", "6000", "--n-cores", "8", "--ws-scale",
            "0.125"],
           ["phased:kmeans+lib", "--length", "4000", "--seed", "3"]]


@pytest.mark.parametrize("i", range(len(EXPORTS)))
def test_trace_corpus_files_cross_read(tools, tmp_path, i):
    """Each package's ``export`` of the same source; each file validated
    and described by both tools with the same lines; the arrays equal."""
    ref, port = tools["trace_corpus"]
    src, *flags = EXPORTS[i]
    paths = {}
    for k, mod in (("ref", ref), ("port", port)):
        paths[k] = tmp_path / f"{k}.npz"
        code, lines = printed(mod.main, ["export", src, str(paths[k]),
                                         *flags])
        assert code == 0 and lines[0].startswith("exported "), lines
    with np.load(paths["ref"]) as a, np.load(paths["port"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])
    for cmd in ("validate", "info"):
        for path in paths.values():
            want = printed(ref.main, [cmd, str(path)])
            assert want[0] == 0
            assert printed(port.main, [cmd, str(path)]) == want
    assert port.validate(str(paths["ref"]))["problems"] == []


def test_trace_corpus_validate_reports_a_bad_file_as_the_reference(
        tools, tmp_path):
    ref, port = tools["trace_corpus"]
    path = tmp_path / "bad.npz"
    np.savez(path, addrs=np.zeros(3, np.uint32))
    want = printed(ref.main, ["validate", str(path)])
    assert want[0] == 1
    assert printed(port.main, ["validate", str(path)]) == want


# ------------------------------------------------------------ trajectories

class Synth:
    """``tests/test_autotune.py``'s deterministic separable objective."""
    name = "synth"

    def __init__(self, space):
        self.space = space

    def evaluate(self, configs):
        return [-sum((2 * i - 3) ** 2 for i in self.space.encode(c))
                for c in configs]

    def describe(self):
        return {"objective": "synth"}


@pytest.mark.parametrize("agent", sorted(j_at.AGENTS))
def test_autotune_trajectory_tools_cross_read(tools, tmp_path, agent):
    """A trajectory from each package's ``Tuner``: ``info``, ``crc`` and
    ``verify`` print the same lines through either tool."""
    ref, port = tools["autotune_trajectory"]
    paths = []
    for k, at in (("ref", j_at), ("port", t_at)):
        s = at.gov_space()
        paths.append(str(tmp_path / f"{k}.jsonl"))
        at.Tuner(s, Synth(s), at.make_agent(agent, s, seed=2, pop=4),
                 trajectory_path=paths[-1]).run(4)
    assert Path(paths[0]).read_bytes() == Path(paths[1]).read_bytes()
    for cmd in ("info", "crc", "verify"):
        want = printed(ref.main, [cmd, *paths])
        assert want[0] == 0 and want[1]
        assert printed(port.main, [cmd, *paths]) == want


def test_autotune_trajectory_verify_fails_on_a_tampered_log(tools,
                                                           tmp_path):
    ref, port = tools["autotune_trajectory"]
    s = t_at.gov_space()
    path = tmp_path / "t.jsonl"
    t_at.Tuner(s, Synth(s), t_at.make_agent("ga", s, seed=1, pop=4),
               trajectory_path=path).run(3)
    lines = path.read_text().splitlines()
    gen = json.loads(lines[2])                  # generation 1
    gen["keys"][0][0] = (gen["keys"][0][0] + 1) % 4
    lines[2] = json.dumps(gen, sort_keys=True, separators=(",", ":"))
    path.write_text("\n".join(lines) + "\n")
    assert port.verify(path)["ok"] is False
    assert printed(port.main, ["verify", str(path)])[0] == 1
    assert printed(ref.main, ["verify", str(path)])[0] == 1


# ------------------------------------------------------------ profiler

def test_profile_engine_totals_are_op_costs():
    """Engine mode on the CPU: the ranked ops (all of them) sum to the
    dispatch's ``op_cost.analyze`` totals, counted again here."""
    prof = load("tools/torch_profile_cell.py")
    out = prof.profile_engine("cfd:Morpheus-Basic:32:36", top=10_000,
                              device="cpu")
    assert out["cell"] == "cfd:Morpheus-Basic:32:36"
    assert sum(r[2] for r in out["ops"]) == pytest.approx(out["flops"])
    assert sum(r[1] for r in out["ops"]) == pytest.approx(out["bytes"])
    assert {"conv_scan", "ext_scan"} <= {r[0] for r in out["ops"]}
    pt = t_cs.RunPoint("cfd", "Morpheus-Basic", 32, 36, 40_000)
    cfg, trace, *_ = t_cs._prepare(pt)
    packed = t_engine.to_device(t_engine.pack(cfg, [trace]), "cpu")
    cost = op_cost.analyze(lambda: t_engine._run_packed(cfg, packed))
    assert (out["flops"], out["bytes"]) == (cost.flops, cost.bytes)
    code, lines = printed(prof.main, ["engine", "cfd:Morpheus-Basic:32:36",
                                      "5", "--device", "cpu"])
    assert code == 0 and lines[0] == "engine device: cpu"
    assert "scan kernels" not in "\n".join(lines)    # the card's only


def test_profile_cell_totals_are_the_dry_runs():
    """Cell mode on the pod's fake group: the report's per-chip FLOPs and
    bytes are the count's, and the ranked ops sum to them."""
    prof = load("tools/torch_profile_cell.py")
    out = prof.profile_cell("h2o-danube-1.8b", "decode_32k", top=10_000)
    assert out["report"]["hlo_flops_per_chip"] == pytest.approx(out["flops"])
    assert out["report"]["hlo_bytes_per_chip"] == pytest.approx(out["bytes"])
    assert sum(r[2] for r in out["ops"]) == pytest.approx(out["flops"])
    assert sum(r[1] for r in out["ops"]) == pytest.approx(out["bytes"])
    assert out["report"]["dominant"] in ("compute", "memory", "collective")
