"""Parity of the port's set-parallel engine (``repro_torch.core.engine``)
with the reference, the epoch-carry contract, the backend switch and the
import guard."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.core import controller as ctl  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro_torch.core import cache_sim as t_cs  # noqa: E402
from repro_torch.core import controller as t_ctl  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import policy as t_policy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _batch(seed=0, n=(500, 250, 600), warm=(0, 120, 211)):
    return [(*tp.trace(n=k, seed=seed + i), w)
            for i, (k, w) in enumerate(zip(n, warm))]


@pytest.mark.parametrize("pred,comp", [(ctl.Predictor.BLOOM, True),
                                       (ctl.Predictor.NONE, False),
                                       (ctl.Predictor.PERFECT, True)])
def test_simulate_batch_matches_reference(pred, comp):
    cfg, pcfg = tp.small_cfg(predictor=pred, compression=comp)
    traces = _batch(seed=tp.case_seed(pred.value, comp))
    ref = j_engine.simulate_batch(cfg, traces, backend="jnp")
    got = t_engine.simulate_batch(pcfg, traces, device="cpu")
    for i in range(len(traces)):
        tp.assert_stats_equal(ref, got, f"{pred.value}/{comp}/trace{i}", i)


def test_simulate_batch_conv_only_and_empty():
    cfg, pcfg = tp.small_cfg(chips=0, sets_per_chip=0)
    traces = _batch(seed=7)
    ref = j_engine.simulate_batch(cfg, traces, backend="jnp")
    got = t_engine.simulate_batch(pcfg, traces, device="cpu")
    for i in range(len(traces)):
        tp.assert_stats_equal(ref, got, f"conv-only/trace{i}", i)
    cfg, pcfg = tp.small_cfg()
    empty = (np.zeros(0, np.uint32), np.zeros(0, bool), np.zeros(0, np.int32))
    got = t_engine.simulate_parallel(pcfg, *empty, 0, device="cpu")
    assert all(float(x) == 0.0 for x in got)


def test_simulate_matches_pallas_interpret():
    """One tiny config against the reference's Pallas kernel, run in
    interpret mode as tests/test_engine.py runs it on the CPU."""
    ok, why = j_engine.backend_status("pallas")
    if not ok:
        pytest.skip(why)
    cfg, pcfg = tp.small_cfg(compression=True)
    addrs, writes, levels = tp.trace(n=300, seed=11)
    ref = j_engine.simulate_parallel(cfg, addrs, writes, levels, 40,
                                     backend="pallas")
    got = t_engine.simulate_parallel(pcfg, addrs, writes, levels, 40,
                                     device="cpu")
    tp.assert_stats_equal(ref, got, "pallas-interpret")


def _epochs(pcfg, trace, cuts, device="cpu"):
    """Replay one trace in epochs ending at ``cuts``; returns the state."""
    addrs, writes, levels, warm = trace
    state = t_engine.init_state(pcfg, 1, device=device)
    lo = 0
    for hi in (*cuts, len(addrs)):
        pt = t_engine.pack(pcfg, [(addrs[lo:hi], writes[lo:hi],
                                   levels[lo:hi], warm)],
                           pos0=[int(state.pos[0])])
        state, _ = t_engine.advance_packed(pcfg, pt, state, device=device)
        lo = hi
    return state


@pytest.mark.parametrize("cuts", [(300,), (1, 2, 640), (97, 400, 401)])
def test_epoch_partition_equals_one_run(cuts):
    _, pcfg = tp.small_cfg(compression=True)
    trace = (*tp.trace(n=800, seed=21), 150)
    mono = t_engine.simulate_batch(pcfg, [trace], device="cpu")
    state = _epochs(pcfg, trace, cuts)
    tp.assert_stats_equal(mono, state.stats, f"epochs{cuts}")
    assert int(state.pos[0]) == 800
    whole = t_engine.state_to_numpy(_epochs(pcfg, trace, ()))
    split = t_engine.state_to_numpy(state)
    for name, a, b in zip(whole._fields[:-2], whole[:-2], split[:-2]):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_reference_state_carried_across():
    """A reference EngineState, carried into the port with
    ``state_from_numpy`` and advanced in both packages, stays identical."""
    cfg, pcfg = tp.small_cfg(compression=True)
    traces = _batch(seed=31, n=(600, 600), warm=(50, 0))
    half = [(a[:250], w[:250], l[:250], wm) for a, w, l, wm in traces]
    rest = [(a[250:], w[250:], l[250:], wm) for a, w, l, wm in traces]
    j_state = j_engine.init_state(cfg, 2)
    j_state, _ = j_engine.advance_packed(cfg, j_engine.pack(cfg, half),
                                         j_state, backend="jnp")
    t_state = t_engine.state_from_numpy(
        pcfg, jax.tree.map(np.asarray, j_state), device="cpu")
    pos0 = [250, 250]
    j_state, j_delta = j_engine.advance_packed(
        cfg, j_engine.pack(cfg, rest, pos0=pos0), j_state, backend="jnp")
    t_state, t_delta = t_engine.advance_packed(
        pcfg, t_engine.pack(pcfg, rest, pos0=pos0), t_state, device="cpu")
    for i in range(2):
        tp.assert_stats_equal(j_delta, t_delta, f"delta{i}", i)
        tp.assert_stats_equal(j_state.stats, t_state.stats, f"total{i}", i)
    ref = jax.tree.map(np.asarray, j_state)
    got = t_engine.state_to_numpy(t_state)
    for name in t_engine.EngineState._fields:
        if name != "stats":
            r, g = getattr(ref, name), getattr(got, name)
            assert r.dtype == g.dtype, name
            np.testing.assert_array_equal(r, g, err_msg=name)
    dec_r = j_engine.decode_state(cfg, j_state, 1)
    dec_g = t_engine.decode_state(pcfg, t_state, 1)
    for k in dec_r:
        np.testing.assert_array_equal(np.asarray(dec_r[k]),
                                      np.asarray(dec_g[k]), err_msg=k)


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    """Without a card, an entry point called without ``device=`` raises
    BackendError; nothing falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pcfg = tp.small_cfg()
    trace = (*tp.trace(n=50), 0)
    calls = [
        lambda: t_engine.simulate_batch(pcfg, [trace]),
        lambda: t_engine.init_state(pcfg, 1),
        lambda: t_engine.advance_packed(
            pcfg, t_engine.pack(pcfg, [trace]),
            t_engine.init_state(pcfg, 1, device="cpu")),
        lambda: t_cs.run_batch([t_cs.RunPoint("cfd", "BL", 32, 0, 200)]),
        lambda: t_policy.best_split("cfd", "BL", grid=(32,), length=200),
        lambda: t_policy.table3(("BL",), ("cfd",), length=200),
        lambda: t_ctl.simulate(pcfg, *trace[:3]),
    ]
    for call in calls:
        with pytest.raises(t_engine.BackendError, match="device='cpu'"):
            call()
    assert t_engine.resolve_backend("torch") == "torch"
    with pytest.raises(t_engine.BackendError, match="unknown backend"):
        t_engine.resolve_backend("pallas")


def test_port_imports_neither_jax_nor_reference():
    prog = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m, mod in sys.modules.items() if mod is not None and (
            m in ("jax", "repro") or m.startswith(("jax.", "jaxlib", "repro.")))]
        assert not bad, bad
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
