"""The port's launchers (``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``) and training loop against the
reference's, on the CPU (``--device cpu``, ``device="cpu"``).

The serving CLI: the printed lines less their wall-clock fields (each
round's seconds and tokens/s), and the ``--trace-out`` (events less
their timestamps), ``--metrics-out`` (less the toolchains' build
counters: XLA's compiles, nvcc's builds), ``--inspect-out`` and
``--record-trace`` files, equal to the reference's in six modes, with
the same weights: the reference's ``LM.init`` is patched inside the test
to return ``seeded_numpy_params(cfg, 0)``, which the port serves.  The
training loop: the reference test's properties
(``tests/test_system.py``) through the port, and the port's losses
against the reference's with the same weights."""
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as j_configs  # noqa: E402
from repro import obs as j_obs  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.train import loop as j_loop  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import obs as t_obs  # noqa: E402
from repro_torch.kernels import attention as t_att  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import seeded_numpy_params  # noqa: E402
from repro_torch.train import loop as t_loop  # noqa: E402

from torch_parity import one_torch_thread  # noqa: E402,F401


@pytest.fixture(autouse=True)
def _obs_off():
    j_obs.disable()
    t_obs.disable()
    yield
    j_obs.disable()
    t_obs.disable()


def seeded_init(arch):
    """A stand-in for the reference's ``LM.init`` that returns the port's
    seeded tree of ``arch``'s reduced config."""
    tree = seeded_numpy_params(t_configs.get(arch).reduced(), 0)
    return lambda self, rng: jax.tree_util.tree_map(jnp.asarray, tree)


WALL = re.compile(r" in \d+\.\d+s \(\d+\.\d+ tok/s\)")

MODES = {
    "static": [],
    "split2": ["--split", "2"],
    "auto": ["--split", "auto"],
    "arrival": ["--split", "auto", "--workload", "tenantA,tenantB",
                "--arrival", "onoff:64,0.5,0.5"],
    "slo": ["--split", "auto", "--workload", "tenantA,tenantB",
            "--slo-ms", "2.5"],
    "tenant_slo": ["--split", "auto", "--tenant-slo",
                   "tenantA:2.5:1:1,tenantB:4:1:0", "--admission"],
}
FILES = {"trace": "--trace-out", "metrics": "--metrics-out",
         "inspect": "--inspect-out", "record": "--record-trace"}
WITH_FILES = ("auto", "slo", "tenant_slo")


def out_files(d):
    return {k: d / f"{k}.{'npz' if k == 'record' else 'json'}"
            for k in FILES}


def run_serve(main, argv, out_dir, capsys, monkeypatch=None):
    """The printed lines of one launcher run, less wall-clock fields and
    with ``out_dir`` as ``OUT``."""
    out_dir.mkdir()
    capsys.readouterr()
    if monkeypatch is not None:       # the reference reads sys.argv
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        main()
    else:
        main(argv)
    text = capsys.readouterr().out.replace(str(out_dir), "OUT")
    return [WALL.sub("", ln) for ln in text.splitlines()]


def trace_events(path):
    evs = json.loads(path.read_text())["traceEvents"]
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in evs]


# the toolchains' own build counters: XLA's compiles in the reference,
# nvcc's builds in the port (none on the CPU)
BUILD_COUNTERS = ("jax_compiles", "jax_compile_seconds", "kernel_builds",
                  "kernel_build_seconds")


def metrics(path):
    snap = json.loads(path.read_text())
    snap["metrics"] = [m for m in snap["metrics"]
                       if m["name"] not in BUILD_COUNTERS]
    return snap


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_cli_equals_the_reference(mode, tmp_path, capsys,
                                        monkeypatch):
    argv = ["--arch", "qwen3-4b"] + MODES[mode]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    wf, pf = out_files(ref_dir), out_files(port_dir)
    flags = lambda files: ([a for k, flag in FILES.items()
                            for a in (flag, str(files[k]))]
                           if mode in WITH_FILES else [])
    monkeypatch.setattr(j_tf.LM, "init", seeded_init("qwen3-4b"))
    want = run_serve(j_serve.main, argv + flags(wf), ref_dir, capsys,
                     monkeypatch)
    j_obs.disable()
    t_att.reset_launches()
    got = run_serve(t_serve.main, argv + flags(pf) + ["--device", "cpu"],
                    port_dir, capsys)
    assert got == want
    assert any(ln.startswith("pool: conv") for ln in got)
    assert t_att.plain_runs["flash_attention"] > 0
    assert t_att.plain_runs["decode_attention"] > 0
    if mode not in WITH_FILES:
        return
    assert trace_events(pf["trace"]) == trace_events(wf["trace"])
    assert metrics(pf["metrics"]) == metrics(wf["metrics"])
    assert json.loads(pf["inspect"].read_text()) == \
        json.loads(wf["inspect"].read_text())
    a, b = np.load(pf["record"]), np.load(wf["record"])
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("main", [t_serve.main, t_train.main])
@pytest.mark.parametrize("flags", [["--mesh", "pod"], ["--mesh", "multipod"],
                                   ["--dry-run"]])
def test_launchers_refuse_the_production_mesh(main, flags):
    with pytest.raises(SystemExit, match="A8.4"):
        main(flags + ["--device", "cpu"])


def test_launchers_run_on_the_card_by_default(monkeypatch):
    """Without ``--device`` the launchers ask for the CUDA card, which
    this host lacks: they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.core.engine import BackendError
    with pytest.raises(BackendError):
        t_serve.main(["--arch", "qwen3-4b"])
    with pytest.raises(BackendError):
        t_train.main(["--arch", "qwen3-4b", "--steps", "2"])


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    t_train.main(["--arch", "h2o-danube-1.8b", "--steps", "12", "--batch",
                  "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
                  "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("train h2o-danube-1.8b-reduced: 12 steps")
    m = re.match(r"done: steps=12 restarts=0 stragglers=\d+ loss "
                 r"(\d+\.\d+) -> (\d+\.\d+)", out[-1])
    assert m and float(m.group(2)) < float(m.group(1))
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000010", "step_00000012"]


# ------------------------------------------------------------ the loop

def test_train_loop_decreases_loss_and_checkpoints(tmp_path):
    cfg = t_configs.get("h2o-danube-1.8b").reduced()
    state, losses, rep = t_loop.train(cfg, steps=24, batch=4, seq=64,
                                      ckpt_dir=str(tmp_path), ckpt_every=8,
                                      device="cpu")
    assert rep.steps_run == 24 and rep.restarts == 0
    assert losses[-1] < losses[0]
    state2, losses2, rep2 = t_loop.train(cfg, steps=30, batch=4, seq=64,
                                         ckpt_dir=str(tmp_path),
                                         ckpt_every=100, device="cpu")
    assert rep2.resumed_from == 24
    assert rep2.steps_run == 6
    assert state2.opt.step == 30


def test_training_step_is_deterministic():
    cfg = t_configs.get("qwen3-4b").reduced()
    out = []
    for _ in range(2):
        _, losses, _ = t_loop.train(cfg, steps=4, batch=2, seq=32, seed=7,
                                    device="cpu")
        out.append(losses)
    np.testing.assert_allclose(out[0], out[1], rtol=1e-6)


@pytest.mark.parametrize("compress,microbatches", [(False, 1), (True, 2)])
def test_train_loop_losses_equal_the_reference(compress, microbatches,
                                               monkeypatch):
    """Both loops from the same weights (the reference's ``init``
    patched): the same batches, schedule and losses within 1e-5."""
    arch = "qwen3-4b"
    tree = seeded_numpy_params(t_configs.get(arch).reduced(), 0)
    monkeypatch.setattr(j_tf.LM, "init", seeded_init(arch))
    kw = dict(steps=5, batch=4, seq=32, seed=3, grad_compression=compress,
              microbatches=microbatches, print_fn=lambda *_: None)
    _, want, _ = j_loop.train(j_configs.get(arch).reduced(), **kw)
    _, got, _ = t_loop.train(t_configs.get(arch).reduced(), device="cpu",
                             init=tree, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5)
