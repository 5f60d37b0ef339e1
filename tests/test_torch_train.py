"""The port's training stack (``repro_torch.data``, ``.optim``,
``.checkpoint``, ``.distributed``, ``.train``, ``LM.loss`` and the flash
kernel's backward) against the reference's, with the same inputs from a
numpy seed, on the CPU (``device="cpu"``: the kernels' plain versions).

Tolerances: the pipeline's batches, the int8 codes and scales and the
checkpoint manifests identical; the schedule within 1e-7; the flash
backward's plain version within 1e-5 of torch autograd through the plain
forward and of itself without the forward's log-sum-exp, the autograd
wrapper within 1e-4 of ``jax.grad`` through the reference's ``_sdpa``,
the plain log-sum-exp within 1e-5 of ``jax.nn.logsumexp`` of its
logits; ``LM.loss`` within 1e-5 relative and every gradient leaf within
1e-3 in relative Frobenius norm on all ten
``reduced()`` configs (compared in the reference's stacked layout);
three AdamW steps' losses within 1e-5 and parameters within 1e-4
relative."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as j_configs  # noqa: E402
from repro.checkpoint import checkpointer as j_ckpt  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import Int8Compressor as JInt8  # noqa: E402
from repro.optim import cosine_with_warmup as j_cosine  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.checkpoint import checkpointer as t_ckpt  # noqa: E402
from repro_torch.checkpoint import latest, restore, save  # noqa: E402
from repro_torch.data import make_pipeline, shard_batch  # noqa: E402
from repro_torch.distributed import fault_tolerance as t_ft  # noqa: E402
from repro_torch.kernels import attention as t_att  # noqa: E402
from repro_torch.models import LM, params_from_numpy  # noqa: E402
from repro_torch.models import seeded_numpy_params  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.weights import param_tree  # noqa: E402
from repro_torch.optim import (AdamW, Int8Compressor,  # noqa: E402
                               constant, cosine_with_warmup, global_norm)
from repro_torch.pytree import Leaf, flatten, from_parts, parts  # noqa: E402
from repro_torch.train import train_step as t_ts  # noqa: E402

from test_torch_models import extra_inputs  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

ARCHS = t_configs.ALL_ARCHS


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def ref_paths(tree) -> dict:
    """The reference's {leaf path: numpy array}, paths as its checkpointer
    names them."""
    names, leaves, _ = j_ckpt._leaf_paths(tree)
    return {n: np.asarray(x) for n, x in zip(names, leaves)}


def port_paths(tree) -> dict:
    return {n: (x.numpy() if isinstance(x, Leaf) else np.asarray(x))
            for n, x in flatten(tree)}


def rel_fro(got, want) -> float:
    want = np.asarray(want, np.float64)
    d = np.linalg.norm(np.asarray(got, np.float64) - want)
    return d / max(np.linalg.norm(want), 1e-30)


def batch_of(cfg, b=2, s=16, seed=1):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            **extra_inputs(cfg, b, s, r)}


def port_model(cfg, tree):
    m = LM(cfg, device="cpu")
    params_from_numpy(m, tree)
    return m


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("vocab,b,s,seed", [(100, 4, 32, 0), (512, 2, 16, 7),
                                            (151936, 3, 64, 3)])
def test_pipeline_batches_equal_the_reference(vocab, b, s, seed):
    ref = j_pipe.make_pipeline(vocab, b, s, seed=seed)
    port = make_pipeline(vocab, b, s, seed=seed)
    for _ in range(5):
        a, p = next(ref), next(port)
        assert sorted(a) == sorted(p)
        for k in a:
            assert a[k].dtype == p[k].dtype
            np.testing.assert_array_equal(a[k], p[k])


def test_pipeline_shapes_and_targets_shift():
    b = next(iter(make_pipeline(vocab_size=100, batch=4, seq=32)))
    assert b["tokens"].shape == (4, 32) and b["targets"].shape == (4, 32)
    flat_in = np.concatenate([b["tokens"][i] for i in range(4)])
    flat_tg = np.concatenate([b["targets"][i] for i in range(4)])
    np.testing.assert_array_equal(flat_in[1:33 - 1], flat_tg[:31])


def test_pipeline_deterministic():
    a = next(iter(make_pipeline(100, 2, 16, seed=7)))
    b = next(iter(make_pipeline(100, 2, 16, seed=7)))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_shard_batch_copies_and_refuses_a_mesh():
    """Without a mesh every row is copied; a mesh that is no
    ``DeviceMesh`` over an initialised world (a duck-typed one) raises
    a one-line error.  Rows over a real mesh: test_torch_distributed.py."""
    nb = next(make_pipeline(100, 2, 8))
    tb = shard_batch(nb, device="cpu")
    assert tb["tokens"].dtype == torch.from_numpy(nb["tokens"]).dtype
    np.testing.assert_array_equal(tb["targets"].numpy(), nb["targets"])
    duck = types.SimpleNamespace(shape={"data": 2, "model": 1})
    with pytest.raises(TypeError, match="initialised world") as e:
        shard_batch(nb, mesh=duck, device="cpu")
    assert "\n" not in str(e.value)


# -------------------------------------------------------------- schedule

@pytest.mark.parametrize("warmup,total", [(10, 100), (3, 24), (1, 1),
                                          (20, 400)])
def test_schedule_equals_the_reference(warmup, total):
    ref, port = j_cosine(warmup, total), cosine_with_warmup(warmup, total)
    for step in list(range(0, total + 3)) + [10 * total]:
        want = float(ref(jnp.int32(step)))
        assert abs(float(port(step)) - want) <= 1e-7, step
        assert abs(float(port(torch.tensor(step))) - want) <= 1e-7, step
    assert float(constant()(5)) == 1.0


def test_cosine_schedule_monotone_sections():
    f = cosine_with_warmup(10, 100)
    v = [float(f(s)) for s in [0, 5, 10, 50, 100]]
    assert v[0] < v[1] < v[2]
    assert v[2] >= v[3] >= v[4]
    assert v[4] >= 0.1 - 1e-6


# --------------------------------------------------------------- AdamW

def stacked_tree(seed=0, scale=1.0):
    """A small tree of the reference's shape: a stacked block leaf of rank
    2 (a norm, decayed), one of rank 3, an unstacked norm (not decayed)
    and a matrix."""
    r = np.random.default_rng(seed)
    f = lambda *s: (scale * r.standard_normal(s)).astype(np.float32)
    return {"blocks": {"l0": {"ln1": f(3, 8), "w": f(3, 8, 4)}},
            "final_norm": f(8), "embed": f(16, 8)}


def leaf_tree(tree):
    """The port's tree of ``stacked_tree``: block leaves split into one
    part a block."""
    def conv(path, a):
        t = torch.from_numpy(a.copy())
        if path[0] == "blocks":
            return Leaf(list(t.unbind(0)), stacked=True)
        return Leaf([t])

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return conv(path, node)
    return walk(tree, ())


@pytest.mark.parametrize("clip,decay,moment", [
    (1.0, 0.1, "float32"), (None, 0.0, "float32"), (0.05, 0.1, "bfloat16")])
def test_adamw_steps_equal_the_reference(clip, decay, moment):
    kw = dict(learning_rate=0.01, weight_decay=decay, clip_norm=clip)
    jopt = JAdamW(moment_dtype=getattr(jnp, moment),
                  schedule=j_cosine(2, 6), **kw)
    topt = AdamW(moment_dtype=getattr(torch, moment),
                 schedule=cosine_with_warmup(2, 6), **kw)
    jp = jnp_tree(stacked_tree(0))
    tp = leaf_tree(stacked_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(4):
        g = stacked_tree(10 + i, scale=0.3)
        jp, js = jopt.update(jnp_tree(g), js, jp)
        tp, ts = topt.update(leaf_tree(g), ts, tp)
    assert ts.step == int(js.step) == 4
    want, got = ref_paths(jp), port_paths(tp)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for tree_j, tree_t in ((js.mu, ts.mu), (js.nu, ts.nu)):
        w, g2 = ref_paths(tree_j), port_paths(tree_t)
        for k in w:
            np.testing.assert_allclose(
                np.asarray(g2[k], np.float32).view(np.float32)
                if moment == "float32" else
                torch.from_numpy(g2[k].view(np.int16)).view(
                    torch.bfloat16).float().numpy(),
                np.asarray(w[k], np.float32), rtol=1e-5, atol=1e-7,
                err_msg=k)


def test_weight_decay_follows_the_reference_leaf_rank():
    """A block layer's norm is a rank-2 leaf in the reference (stacked
    over the blocks) and decays; ``final_norm`` does not."""
    opt = AdamW(learning_rate=0.1, weight_decay=0.5, clip_norm=None)
    tp = leaf_tree(stacked_tree(0))
    before = port_paths(tp)
    zero = leaf_tree({"blocks": {"l0": {"ln1": np.zeros((3, 8), np.float32),
                                        "w": np.zeros((3, 8, 4), np.float32)}},
                      "final_norm": np.zeros(8, np.float32),
                      "embed": np.zeros((16, 8), np.float32)})
    opt.update(zero, opt.init(tp), tp)
    after = port_paths(tp)
    assert not np.allclose(after["blocks/l0/ln1"], before["blocks/l0/ln1"])
    np.testing.assert_array_equal(after["final_norm"], before["final_norm"])
    assert tp["blocks"]["l0"]["ln1"].ndim == 2


def test_adamw_optimizes_quadratic():
    opt = AdamW(learning_rate=0.1, weight_decay=0.0, clip_norm=None)
    w = torch.tensor([3.0, -2.0], requires_grad=True)
    params = {"w": Leaf([w])}
    state = opt.init(params)
    for _ in range(200):
        loss = torch.sum(torch.square(w - 1.0))
        g, = torch.autograd.grad(loss, [w])
        params, state = opt.update({"w": Leaf([g])}, state, params)
    assert float(torch.sum(torch.square(w - 1.0))) < 1e-3


def test_global_norm_sums_every_part():
    tp = leaf_tree(stacked_tree(3))
    want = np.sqrt(sum(np.sum(np.square(a.astype(np.float64)))
                       for a in port_paths(tp).values()))
    assert abs(float(global_norm(tp)) - want) <= 1e-5 * want


# ------------------------------------------------------ int8 compression

def test_int8_codes_and_scales_equal_the_reference():
    """One scale a reference leaf, over all of a stacked leaf's blocks:
    the codes bit-identical, and the residual after 5 roundtrips."""
    jc, tc = JInt8(), Int8Compressor()
    g = stacked_tree(5, scale=0.01)
    g["blocks"]["l0"]["w"][1] *= 40          # one block dominates the scale
    for path, a in ref_paths(jnp_tree(g)).items():
        leaf = port_paths(leaf_tree(g))[path]
        np.testing.assert_array_equal(leaf, a)
    jt, tt = jnp_tree(g), leaf_tree(g)
    for path, leaf in flatten(tt):
        q, s = tc.quantize(leaf)
        jq, js = jc.quantize(dict((k, v) for k, v in
                                  ref_paths(jt).items())[path])
        assert float(s) == float(js), path
        np.testing.assert_array_equal(np.stack([x.numpy() for x in q])
                                      if leaf.stacked else q[0].numpy(),
                                      np.asarray(jq), err_msg=path)
    js_, ts_ = jc.init(jt), tc.init(tt)
    for i in range(5):
        gi = stacked_tree(20 + i, scale=0.02)
        jo, js_ = jc.roundtrip(jnp_tree(gi), js_)
        to, ts_ = tc.roundtrip(leaf_tree(gi), ts_)
        for k, w in ref_paths(jo).items():
            np.testing.assert_array_equal(port_paths(to)[k], w, err_msg=k)
    for k, w in ref_paths(js_.residual).items():
        np.testing.assert_array_equal(port_paths(ts_.residual)[k], w,
                                      err_msg=k)


def test_int8_roundtrip_error_bounded():
    comp = Int8Compressor()
    w = torch.from_numpy(np.random.default_rng(0).normal(size=512)
                         .astype(np.float32))
    g = {"w": Leaf([w])}
    out, _ = comp.roundtrip(g, comp.init(g))
    scale = float(w.abs().max()) / 127
    assert float((out["w"].parts[0] - w).abs().max()) <= scale * 0.5 + 1e-6


def test_int8_error_feedback_unbiased_over_time():
    comp = Int8Compressor()
    w = torch.tensor([0.001, 0.5, -0.3, 1e-5])
    g = {"w": Leaf([w])}
    state = comp.init(g)
    acc = torch.zeros(4)
    n = 64
    for _ in range(n):
        out, state = comp.roundtrip(g, state)
        acc = acc + out["w"].parts[0]
    scale = float(w.abs().max()) / 127
    np.testing.assert_allclose((acc / n).numpy(), w.numpy(),
                               atol=1.5 * scale / (2 * n) + 1e-9)


# ------------------------------------------------------------ checkpoint

def both_states(arch, dtype, compress: bool):
    """(reference TrainState, port TrainState) of ``arch``'s reduced
    config in ``dtype`` with the same weights (``seeded_numpy_params``),
    AdamW moments and residual at 0."""
    tcfg = dataclasses.replace(t_configs.get(arch).reduced(),
                               param_dtype=dtype)
    jcfg = dataclasses.replace(j_configs.get(arch).reduced(),
                               param_dtype=dtype)
    tree = seeded_numpy_params(tcfg, 0)
    jparams = jax.tree_util.tree_map(
        lambda a, t: jnp.asarray(a, t.dtype), tree,
        j_tf.LM(jcfg).init(jax.random.PRNGKey(0)))
    jopt, topt = JAdamW(), AdamW()
    jstate = j_ts.TrainState(jparams, jopt.init(jparams),
                             JInt8().init(jparams) if compress else None)
    tstate = t_ts.init_state(LM(tcfg, device="cpu"), topt, tree,
                             Int8Compressor() if compress else None)
    return jstate, tstate


@pytest.mark.parametrize("arch,compress", [("qwen3-4b", False),
                                           ("gemma3-27b", True),
                                           ("jamba-1.5-large-398b", True)])
def test_checkpoint_manifest_equals_the_reference(tmp_path, arch, compress):
    """Leaf paths, indices, shapes and dtypes of a TrainState checkpoint
    (prefix layers, stacked blocks, moments, step, residual)."""
    import json
    jstate, tstate = both_states(arch, "float32", compress)
    j_ckpt.save(tmp_path / "ref", 3, jstate)
    save(tmp_path / "port", 3, tstate)
    jm = json.loads((tmp_path / "ref" / "step_00000003" /
                     "manifest.json").read_text())
    tm = json.loads((tmp_path / "port" / "step_00000003" /
                     "manifest.json").read_text())
    assert tm == jm
    assert any(e["path"] == ".opt/.step" and e["dtype"] == "int32"
               for e in tm["leaves"])
    assert any(e["path"].startswith(".params/blocks/l0/")
               for e in tm["leaves"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b"])
def test_checkpoints_cross_load(tmp_path, arch, dtype):
    """A reference checkpoint restores into the port and the port's into
    the reference, every leaf equal (bf16 as raw bits)."""
    jstate, tstate = both_states(arch, dtype, compress=True)
    # make every leaf distinct: a few reference AdamW steps on noise
    jopt = JAdamW()
    g = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.random.default_rng(p.size).standard_normal(
            p.shape), p.dtype), jstate.params)
    params, opt = jopt.update(g, jstate.opt, jstate.params)
    jstate = j_ts.TrainState(params, opt, jstate.comp._replace(
        residual=jax.tree_util.tree_map(lambda x: x + 0.5,
                                        jstate.comp.residual)))
    j_ckpt.save(tmp_path / "ref", 7, jstate)
    step, restored = restore(latest(tmp_path / "ref"), tstate)
    assert step == 7 and restored.opt.step == 1
    want = ref_paths(jstate)
    got = port_paths(restored)
    assert sorted(want) == sorted(got)
    for k in want:
        w = want[k]
        if w.dtype.name == "bfloat16":
            w = w.view(np.uint16)
        np.testing.assert_array_equal(np.asarray(got[k]), w, err_msg=k)
    # and back: the port's checkpoint into a fresh reference template
    save(tmp_path / "port", 9, restored)
    step, back = j_ckpt.restore(j_ckpt.latest(tmp_path / "port"),
                                both_states(arch, dtype, True)[0])
    assert step == 9
    for k, w in ref_paths(back).items():
        a, b = np.asarray(w), want[k]
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.bfloat16)}}
    save(tmp_path, 10, tree)
    save(tmp_path, 20, {"a": tree["a"] * 2,
                        "nested": {"b": tree["nested"]["b"] * 2}})
    assert latest(tmp_path).name == "step_00000020"
    step, restored = restore(latest(tmp_path), tree)
    assert step == 20
    assert torch.equal(restored["a"], tree["a"] * 2)
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert float(restored["nested"]["b"][0]) == 2.0


def test_checkpoint_async_and_gc_keeps_last(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in range(5):
        save(tmp_path, s, tree, keep=2)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_00000003", "step_00000004"]
    out = save(tmp_path / "async", 1, tree, async_=True)
    for _ in range(200):
        if (out / "manifest.json").exists():
            break
        import time
        time.sleep(0.01)
    assert latest(tmp_path / "async") == out


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save(tmp_path, 1, {"a": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        restore(latest(tmp_path), {"a": torch.zeros((3,))})
    with pytest.raises(KeyError):
        restore(latest(tmp_path), {"b": torch.zeros((2, 2))})


# ------------------------------------------------------------ supervisor

def _batches():
    while True:
        yield {"x": np.ones(2)}


def test_supervisor_restarts_after_failure(tmp_path):
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == 7:
            raise RuntimeError("injected node failure")
        return state + 1, {"loss": 1.0 / calls["n"]}

    sup = t_ft.TrainSupervisor(t_ft.SupervisorConfig(
        ckpt_dir=str(tmp_path), ckpt_every=2, max_restarts=2))
    state, rep = sup.run(step_fn, torch.zeros(()), _batches(), num_steps=10)
    assert rep.steps_run == 10 and rep.restarts == 1
    assert float(state) == 10.0


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    def step_fn(state, batch):
        raise RuntimeError("persistent failure")

    sup = t_ft.TrainSupervisor(t_ft.SupervisorConfig(
        ckpt_dir=str(tmp_path), max_restarts=2))
    with pytest.raises(RuntimeError):
        sup.run(step_fn, torch.zeros(()), _batches(), num_steps=5)


def test_supervisor_detects_stragglers(tmp_path, monkeypatch):
    """On a fake clock: one slow step among 2 ms steps, whatever the
    host's load."""
    now = [0.0]
    monkeypatch.setattr(t_ft.time, "perf_counter", lambda: now[0])
    seen = []

    def step_fn(state, batch):
        now[0] += 0.25 if (not seen and float(state) >= 5) else 0.002
        return state + 1, {"loss": 0.0}

    sup = t_ft.TrainSupervisor(
        t_ft.SupervisorConfig(ckpt_dir=str(tmp_path / "x"), ckpt_every=100,
                              heartbeat_path=str(tmp_path / "hb.json")),
        on_straggler=lambda s, dt: seen.append((s, dt)))
    _, rep = sup.run(step_fn, torch.zeros(()), _batches(), num_steps=10)
    assert rep.stragglers == 1 and seen == [(5, 0.25)]
    assert '"step": 10' in (tmp_path / "hb.json").read_text()


def test_supervisor_resumes_from_checkpoint(tmp_path):
    def step_fn(state, batch):
        return state + 1, {"loss": 0.0}

    cfg = t_ft.SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=5)
    t_ft.TrainSupervisor(cfg).run(step_fn, torch.zeros(()), _batches(),
                                  num_steps=5)
    state, rep = t_ft.TrainSupervisor(cfg).run(
        step_fn, torch.zeros(()), _batches(), num_steps=8)
    assert rep.resumed_from == 5 and rep.steps_run == 3
    assert float(state) == 8.0


# ----------------------------------------------------------- flash backward

FLASH_CASES = [  # b, s, t, h, kv, hd, hdv, causal, window, softcap
    (2, 16, 16, 4, 4, 16, 16, True, 0, 0.0),       # G = 1
    (2, 24, 24, 8, 2, 16, 16, True, 0, 0.0),       # G = 4
    (1, 40, 40, 4, 1, 32, 32, True, 8, 0.0),       # window
    (1, 20, 20, 4, 2, 16, 16, True, 0, 5.0),       # soft cap (bites)
    (2, 12, 30, 4, 2, 16, 16, False, 0, 0.0),      # cross-attention
    (1, 10, 10, 4, 4, 24, 8, True, 0, 0.0),        # hdv != hd
    (1, 18, 18, 8, 2, 16, 16, False, 5, 30.0),     # non-causal window
]
KEYLESS = (1, 12, 4, 2, 2, 16, 16, True, 2, 0.0)   # rows 5-11 have no key


def flash_inputs(case, seed=0, big=1.0):
    b, s, t, h, kv, hd, hdv = case[:7]
    r = np.random.default_rng(seed)
    return [torch.from_numpy(big * r.standard_normal(sh).astype(np.float32))
            for sh in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hdv),
                       (b, s, h, hdv))]


@pytest.mark.parametrize("case", FLASH_CASES + [KEYLESS])
def test_flash_backward_plain_matches_autograd(case):
    q, k, v, do = flash_inputs(case, big=2.0 if case[9] else 1.0)
    kw = dict(causal=case[7], window=case[8], softcap=case[9])
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = t_att.flash_attention_plain(*qkv, **kw)
    want = torch.autograd.grad(o, qkv, do)
    got = t_att.flash_attention_backward_plain(q, k, v, o.detach(), do,
                                               **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    if case is KEYLESS:          # keyless rows: no gradient to their q
        assert float(got[0][:, 5:].abs().max()) == 0.0
        # ... and each key's dV gets dO / T from each of them
        b, s, t, h, kv = case[:5]
        g = h // kv
        dv_keyless = do[:, 5:].reshape(b, s - 5, kv, g, -1).sum((1, 3)) / t
        assert float(dv_keyless.abs().max()) > 0


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_autograd_matches_the_reference_sdpa(case):
    """``flash_attention``'s gradients (the autograd Function, its
    backward's plain version here) against ``jax.grad`` through the
    reference model's ``_sdpa`` with its masks."""
    b, s, t, h, kv, hd, hdv, causal, window, cap = case
    q, k, v, do = flash_inputs(case, seed=3, big=2.0 if cap else 1.0)
    i, j = np.arange(s)[:, None], np.arange(t)[None, :]
    mask = (j <= i) if causal else np.ones((s, t), bool)
    if window:
        mask = mask & (i - j < window)
    cfg = types.SimpleNamespace(logit_softcap=cap)

    def f(q_, k_, v_):
        out = j_attn._sdpa(q_, k_, v_, jnp.asarray(mask)[None], cfg)
        return jnp.sum(out * jnp.asarray(do.numpy()))
    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x.numpy())
                                            for x in (q, k, v)))
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    t_att.reset_launches()
    o = t_att.flash_attention(*qkv, causal=causal, window=window,
                              softcap=cap)
    got = torch.autograd.grad(o, qkv, do)
    assert t_att.plain_runs["flash_attention_backward"] == 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("case", FLASH_CASES + [KEYLESS])
def test_flash_lse_plain_matches_the_reference_logits(case):
    """The plain log-sum-exp the forward keeps (base 2) against
    ``jax.nn.logsumexp`` of the reference ``_sdpa``'s logits (its scale,
    soft cap and -2e38 mask), over the rows with a valid key."""
    b, s, t, h, kv, hd, hdv, causal, window, cap = case
    q, k, _, _ = flash_inputs(case, seed=4, big=2.0 if cap else 1.0)
    i, j = np.arange(s)[:, None], np.arange(t)[None, :]
    mask = (j <= i) if causal else np.ones((s, t), bool)
    if window:
        mask = mask & (i - j < window)
    qg = jnp.asarray(q.numpy()).reshape(b, s, kv, h // kv, hd)
    logits = jnp.einsum("bsngd,btnd->bnsgt", qg,
                        jnp.asarray(k.numpy())) * hd ** -0.5
    logits = j_attn.L.softcap(logits, cap)
    logits = logits + jnp.where(jnp.asarray(mask)[None, None, :, None, :],
                                0.0, j_attn.NEG)
    want = np.asarray(jax.nn.logsumexp(logits, axis=-1)).transpose(
        0, 2, 1, 3).reshape(b, s, h)
    got = t_att.flash_lse_plain(q, k, causal=causal, window=window,
                                softcap=cap)
    assert got.dtype == torch.float32 and got.is_contiguous()
    keyed = mask.any(-1)
    assert keyed.any()
    np.testing.assert_allclose(got.numpy()[:, keyed] * np.log(2.0),
                               want[:, keyed], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inputs_without_grad"])
def test_flash_attention_keeps_an_lse_only_for_a_gradient(mode,
                                                          monkeypatch):
    """The forward asks for the log-sum-exp only when grad mode is on and
    an input requires grad (serving runs under ``no_grad``), and saves it
    for the backward."""
    case = FLASH_CASES[2]
    q, k, v, _ = flash_inputs(case)
    kw = dict(causal=case[7], window=case[8], softcap=case[9])
    asked = []
    forward = t_att._flash_forward

    def spy(*args, **kwargs):
        asked.append(kwargs["with_lse"])
        return forward(*args, **kwargs)
    monkeypatch.setattr(t_att, "_flash_forward", spy)
    qkv = [x.clone().requires_grad_(mode != "inputs_without_grad")
           for x in (q, k, v)]
    if mode == "no_grad":
        with torch.no_grad():
            o = t_att.flash_attention(*qkv, **kw)
    else:
        o = t_att.flash_attention(*qkv, **kw)
    assert asked == [mode == "grad"]
    if mode == "grad":
        lse = o.grad_fn.saved_tensors[4]
        assert torch.equal(lse, t_att.flash_lse_plain(q, k, **kw))
    else:
        assert o.grad_fn is None


@pytest.mark.parametrize("case", FLASH_CASES + [KEYLESS])
def test_flash_backward_plain_reads_the_forward_lse(case):
    """The plain backward with the forward's log-sum-exp (P from it, 1/T
    in a row with no key) gives what it gives without (the softmax)."""
    q, k, v, do = flash_inputs(case, seed=5, big=2.0 if case[9] else 1.0)
    kw = dict(causal=case[7], window=case[8], softcap=case[9])
    o, lse = t_att.flash_attention_with_lse(q, k, v, **kw)
    assert lse.shape == q.shape[:3]
    t_att.reset_launches()
    with_lse = t_att.flash_attention_backward(q, k, v, o, do, lse, **kw)
    without = t_att.flash_attention_backward(q, k, v, o, do, **kw)
    assert t_att.plain_runs["flash_attention_backward"] == 2
    for a, b in zip(with_lse, without):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_decode_attention_refuses_inputs_that_require_grad():
    q = torch.randn(1, 4, 16, requires_grad=True)
    k = torch.randn(1, 6, 2, 16)
    valid = torch.ones((1, 6), dtype=torch.bool)
    with pytest.raises(RuntimeError, match="no backward"):
        t_att.decode_attention(q, k, k, valid)
    with torch.no_grad():
        assert t_att.decode_attention(q, k, k, valid).shape == (1, 4, 16)


# ------------------------------------------------------ LM.loss and grads

def moe_margin(jm, jparams, jbatch):
    """The reference's smallest top-k margin (k-th gate less the (k+1)-th)
    over every MoE call of a forward: routing compared above 1e-4 only."""
    margins = []
    real = j_moe._moe_mlp_dense

    def record(gates, k):
        g = np.sort(np.asarray(gates), -1)
        margins.append(float((g[:, -k] - g[:, -k - 1]).min()))

    def tap(p, x, cfg):
        x2 = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        jax.debug.callback(lambda g: record(g, cfg.top_k),
                           jax.nn.softmax(x2 @ p["router"], -1))
        return real(p, x, cfg)
    j_moe._moe_mlp_dense = tap
    try:
        jax.block_until_ready(jm.forward(jparams, jbatch))
    finally:
        j_moe._moe_mlp_dense = real
    return min(margins) if margins else None


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(arch):
    tcfg = t_configs.get(arch).reduced()
    jcfg = j_configs.get(arch).reduced()
    tree = seeded_numpy_params(tcfg, 0)
    nb = batch_of(tcfg)
    jm = j_tf.LM(jcfg)
    jparams = jnp_tree(tree)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    if tcfg.num_experts:
        margin = moe_margin(jm, jparams, jbatch)
        assert margin is not None and margin > 1e-4, (
            f"{arch}: a top-k near tie ({margin}) on this batch")
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jparams, jbatch)
    tm = port_model(tcfg, tree)
    tm.requires_grad_(True)
    pt = param_tree(tm)
    t_att.reset_launches()
    loss = tm.loss({k: torch.from_numpy(v) for k, v in nb.items()})
    flat = parts(pt)
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for g, p in zip(gs, flat)]
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    want, got = ref_paths(jg), port_paths(from_parts(pt, gs))
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert rel_fro(got[k], want[k]) <= 1e-3, k
    has_attn = any(s.mixer == "attn" for s in tm.specs)
    assert (t_att.plain_runs["flash_attention_backward"] > 0) == has_attn


def test_cross_entropy_takes_the_padded_vocabulary():
    vocab, padded = 500, 512           # a vocabulary padded to 512
    r = np.random.default_rng(0)
    logits = r.standard_normal((2, 3, padded)).astype(np.float32)
    targets = r.integers(0, vocab, (2, 3)).astype(np.int32)
    from repro.models import layers as j_layers
    want = float(j_layers.cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(targets), vocab))
    got = float(t_layers.cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(targets), vocab))
    assert abs(got - want) <= 1e-6 * abs(want)
    cut = float(t_layers.cross_entropy(
        torch.from_numpy(logits[..., :vocab]), torch.from_numpy(targets),
        vocab))
    assert cut < got           # the padded tail takes part in the sum


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_give_the_same_gradients(policy, monkeypatch):
    cfg = t_configs.get("gemma2-9b").reduced()
    tree = seeded_numpy_params(cfg, 0)
    nb = {k: torch.from_numpy(v) for k, v in batch_of(cfg).items()}
    out = []
    for remat in (False, True):
        monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
        m = port_model(cfg, tree)
        m.requires_grad_(True)
        loss = m.loss(nb, remat=remat)
        out.append((float(loss), [g.clone() for g in torch.autograd.grad(
            loss, parts(param_tree(m)))]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_serving_forward_needs_no_grad():
    cfg = t_configs.get("qwen3-4b").reduced()
    m = port_model(cfg, seeded_numpy_params(cfg, 0))
    m.requires_grad_(True)
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    assert not m({"tokens": tokens}).requires_grad
    assert all(not p.requires_grad for p in
               LM(cfg, device="cpu").parameters())


# ------------------------------------------------------------ train steps

@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b"])
@pytest.mark.parametrize("microbatches,compress", [(1, False), (2, False),
                                                   (1, True), (2, True)])
def test_train_steps_match_the_reference(arch, microbatches, compress):
    """Three AdamW steps (with microbatches, with the int8 compressor):
    losses within 1e-5, ``grad_norm`` within 1e-4 and the parameters
    within 1e-4 relative (``assert_params_close``)."""
    tcfg = t_configs.get(arch).reduced()
    jcfg = j_configs.get(arch).reduced()
    tree = seeded_numpy_params(tcfg, 0)
    batches = [batch_of(tcfg, b=4, s=16, seed=10 + i) for i in range(3)]
    sched = dict(learning_rate=1e-2)
    jm = j_tf.LM(jcfg)
    jopt = JAdamW(schedule=j_cosine(2, 3), **sched)
    jcomp = JInt8() if compress else None
    jp = jnp_tree(tree)
    jstate = j_ts.TrainState(jp, jopt.init(jp),
                             jcomp.init(jp) if compress else None)
    jstep = jax.jit(j_ts.make_train_step(jm, jopt, microbatches=microbatches,
                                         compressor=jcomp))
    tm = LM(tcfg, device="cpu")
    topt = AdamW(schedule=cosine_with_warmup(2, 3), **sched)
    tcomp = Int8Compressor() if compress else None
    tstate = t_ts.init_state(tm, topt, tree, tcomp)
    tstep = t_ts.make_train_step(tm, topt, microbatches=microbatches,
                                 compressor=tcomp)
    for nb in batches:
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in nb.items()})
        tstate, tmet = tstep(tstate, {k: torch.from_numpy(v)
                                      for k, v in nb.items()})
        jl, tl = float(jmet["loss"]), float(tmet["loss"])
        assert abs(tl - jl) <= 1e-5 * abs(jl)
        jn, tn = float(jmet["grad_norm"]), float(tmet["grad_norm"])
        assert abs(tn - jn) <= 1e-4 * jn
    assert tstate.opt.step == int(jstate.opt.step) == 3
    want, got = ref_paths(jstate.params), port_paths(tstate.params)
    for k in want:
        assert_params_close(got[k], want[k], sched["learning_rate"], 3, k)


def assert_params_close(got, want, lr, steps, ctx):
    """A leaf after ``steps`` AdamW steps within 1e-4 in relative Frobenius
    norm, but for at most 2 elements that may move apart by a whole
    update (up to ``2 lr`` a step): Adam's first normalised step of an
    element is ``sign(g) lr``, so an element whose gradient is a sum that
    cancels to roundoff (deepseek-moe's embedding element (75, 39) on
    step 2 here: -8.6e-6 in the port, 7.4e-7 in the reference, in a leaf
    whose gradient reaches 1.6) moves the other way.  Such an element's
    gradient is within the 1e-3 bound of the gradient test; a fault of
    the port's gradient or update moves many elements."""
    d = np.abs(got - want)
    out = d > 1e-4 * np.abs(want).max() + 1e-7
    assert out.sum() <= 2, (ctx, int(out.sum()))
    assert (d[out] <= 2 * lr * steps).all(), ctx
    assert rel_fro(got[~out], want[~out]) <= 1e-4, ctx
