"""The spans of the port's serving and training path (``repro_torch.obs``
sites in ``serving/engine.py``, ``serving/paged_kv.py``,
``models/transformer.py``, ``models/moe.py`` and ``train/train_step.py``).

On the CPU: the span tree a batch and a training step leave (names,
parents, one ``serve.batch`` over each batch's spans), the counts the
spans carry against counts made independently of them (the read-backs a
decode step from the model's MoE layers, each MoE call's ``segments``
from the router's own choice, the pool's read-backs from the keys'
tiers and the pool's stats), outputs bit-identical with tracing on and
off, and spans on an injected ``time.time_ns`` clock.  On the card only
(marker ``gpu``): the train step's phase spans' device edges against the
step's CUDA-event time, and a decode step's span against its first
kernel on the profiler's timeline.  This file imports no JAX, so the
card host can run it:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_spans.py
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import configs, obs
from repro_torch.core import address_separation as asep
from repro_torch.models import LM, seeded_numpy_params
from repro_torch.models import moe as MoE
from repro_torch.optim import AdamW
from repro_torch.serving import Engine, Request
from repro_torch.serving.engine import PAGE_TOKENS, _prefix_hash
from repro_torch.serving.paged_kv import page_key, pool_to_numpy
from repro_torch.train.train_step import init_state, make_train_step

ARCHS = {"dense": "qwen3-4b", "moe": "deepseek-moe-16b"}
PROMPT, NEW, BATCHES = 32, 4, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _obs_off():
    obs.disable()
    yield
    obs.disable()


def _prompts(cfg, batch: int):
    rng = np.random.default_rng(batch)
    # the first batch's last prompt repeats its first: the pool then hits
    ps = [rng.integers(0, cfg.vocab_size, PROMPT).tolist() for _ in range(3)]
    return ps if batch else ps[:2] + [ps[0]]


def _serve(arch: str, traced: bool):
    """Two batches through a fresh ``Engine`` of ``arch``'s reduced config:
    (engine, tokens a batch, pool stats after each batch, pool state, the
    logits of every prefill and decode step, the tracer or None)."""
    cfg = configs.get(ARCHS[arch]).reduced()
    eng = Engine(LM(cfg, device="cpu"), seeded_numpy_params(cfg, 0),
                 max_len=PROMPT + NEW)
    logits = []
    for name in ("prefill", "decode_step"):
        fn = getattr(eng.model, name)

        def keep(*a, _fn=fn, **k):
            out = _fn(*a, **k)
            logits.append(out[0].clone())
            return out
        setattr(eng.model, name, keep)
    if traced:
        obs.enable(clock=time.time_ns, metrics=False)
    tokens, stats = [], []
    for k in range(BATCHES):
        reqs = [Request(10 * k + i, p, NEW)
                for i, p in enumerate(_prompts(cfg, k))]
        eng.run(reqs)
        tokens.append([r.out_tokens for r in reqs])
        stats.append(eng.pool.stats)
    tracer = obs.tracer()
    obs.disable()
    return eng, tokens, stats, pool_to_numpy(eng.pool), logits, tracer


def _by_id(records):
    return {r.id: r for r in records}


def _ancestor(rec, ids, name):
    """The nearest span named ``name`` above ``rec``, or None."""
    while rec.parent is not None:
        rec = ids[rec.parent]
        if rec.name == name:
            return rec
    return None


def _children(records, parent):
    return [r for r in records if r.parent == parent.id]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serving_outputs_bit_identical_with_tracing_on(arch):
    _, tok0, st0, pool0, lg0, _ = _serve(arch, False)
    _, tok1, st1, pool1, lg1, tracer = _serve(arch, True)
    assert tracer.records
    assert tok0 == tok1 and st0 == st1
    assert len(lg0) == len(lg1) == BATCHES * NEW
    assert all(torch.equal(a, b) for a, b in zip(lg0, lg1))
    for name, a in pool0.items():
        if name != "stats":
            np.testing.assert_array_equal(a, pool1[name], err_msg=name)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serving_span_tree(arch):
    t_lo = time.time_ns()
    eng, _, _, _, _, tracer = _serve(arch, True)
    t_hi = time.time_ns()
    recs, ids = tracer.records, _by_id(tracer.records)
    # the injected clock: integer ns of time.time_ns, in order
    assert all(isinstance(r.t0, int) and t_lo <= r.t0 <= r.t1 <= t_hi
               for r in recs)
    batches = [r for r in recs if r.name == "serve.batch"]
    assert [b.tags["batch"] for b in batches] == [1, 2]
    assert all(b.parent is None for b in batches)
    assert [b.tags["rids"] for b in batches] == [[0, 1, 2], [10, 11, 12]]
    assert {(b.tags["b"], b.tags["prompt_tokens"]) for b in batches} == \
        {(3, PROMPT)}
    # every other span has one serve.batch above it, and lies inside it
    for r in recs:
        if r.name != "serve.batch":
            top = _ancestor(r, ids, "serve.batch")
            assert top is not None, r.name
            assert top.t0 <= r.t0 <= r.t1 <= top.t1
    parent_of = {"serve.consult": "serve.batch",
                 "serve.prefill": "serve.batch",
                 "serve.decode_step": "serve.batch",
                 "serve.readback": "serve.decode_step",
                 "lm.decode_step": "serve.decode_step",
                 "pool.lookup": "serve.consult",
                 "pool.write": "serve.consult",
                 "pool.readback": "pool.lookup",
                 "decode.attn": "lm.decode_step",
                 "decode.mlp": "lm.decode_step",
                 "moe.route": "moe.dispatch",
                 "moe.readback": "moe.dispatch",
                 "moe.experts": "moe.dispatch"}
    for r in recs:
        if r.name in parent_of:
            assert ids[r.parent].name == parent_of[r.name], r.name
        elif r.name == "moe.dispatch":     # the prefill's and each step's
            assert ids[r.parent].name in ("serve.prefill", "decode.mlp")
    cfg = eng.model.cfg
    for b in batches:
        kids = [r.name for r in _children(recs, b)]
        assert kids == ["serve.consult", "serve.prefill"] + \
            ["serve.decode_step"] * NEW
    for step in (r for r in recs if r.name == "lm.decode_step"):
        layers = _children(recs, step)
        assert [(r.name, r.tags["layer"]) for r in layers] == [
            (n, li) for li in range(cfg.num_layers)
            for n in ("decode.attn", "decode.mlp")]
    names = {r.name for r in recs}
    assert ("moe.dispatch" in names) == (arch == "moe")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_readbacks_a_decode_step_are_the_moe_layers_and_the_sampler(arch):
    eng, _, _, _, _, tracer = _serve(arch, True)
    recs, ids = tracer.records, _by_id(tracer.records)
    moe_layers = sum(s.mlp == "moe" for s in eng.model.specs)
    assert moe_layers == (0 if arch == "dense" else
                          eng.model.cfg.num_layers - 1)
    steps = [r for r in recs if r.name == "serve.decode_step"]
    ran = [s for s in steps
           if any(r.name == "lm.decode_step" for r in _children(recs, s))]
    assert len(ran) == BATCHES * (NEW - 1)
    reads = {s.id: 0 for s in steps}
    for r in recs:
        step = _ancestor(r, ids, "serve.decode_step")
        if r.name.endswith(".readback") and step is not None:
            reads[step.id] += 1
    assert {reads[s.id] for s in ran} == {moe_layers + 1}
    # the loop's last iteration reads the last tokens and stops
    assert {reads[s.id] for s in steps if s not in ran} == {1}
    for r in recs:
        if r.name == "serve.readback":
            assert r.tags["bytes"] == 3 * 4        # three int32 tokens
        if r.name == "moe.readback":
            assert r.tags["bytes"] == 8 * (eng.model.cfg.num_experts + 1)


def test_moe_segments_are_the_kept_experts_of_the_routing(monkeypatch):
    """Each ``moe.experts`` span's ``segments`` equals the distinct
    experts given a kept pair by the router's own choice, taken from
    ``moe.route`` on the layer's input beside the layer."""
    want = []
    layer = MoE.moe_mlp

    def routed(p, x, cfg):
        r = MoE.route(p, x.reshape(-1, x.shape[-1]), cfg)
        want.append(len(set(r.expert[r.keep].tolist())))
        return layer(p, x, cfg)
    monkeypatch.setattr(MoE, "moe_mlp", routed)
    eng, _, _, _, _, tracer = _serve("moe", True)
    got = [r.tags["segments"] for r in tracer.records
           if r.name == "moe.experts"]
    moe_layers = eng.model.cfg.num_layers - 1
    assert len(got) == len(want) == BATCHES * NEW * moe_layers
    assert got == want
    tokens = [r.tags["tokens"] for r in tracer.records
              if r.name == "moe.dispatch"]
    assert tokens == ([3 * PROMPT] * moe_layers
                      + [3] * (NEW - 1) * moe_layers) * BATCHES


def test_pool_readbacks_by_tier():
    """One read-back a key of the conventional tier; on the extended tier
    three a key, two more a miss (the victim's rows): the tiers from the
    keys' routes, the misses from the pool's stats."""
    eng, _, stats, _, _, tracer = _serve("dense", True)
    recs = tracer.records
    ids = _by_id(recs)
    amap = eng.pool.cfg.amap
    cfg = eng.model.cfg
    prev = stats[0]._replace(**{f: 0 for f in stats[0]._fields})
    for k, batch in enumerate(r for r in recs if r.name == "serve.batch"):
        keys = [page_key(_prefix_hash(p[:(pg + 1) * PAGE_TOKENS]), 0, pg)
                for p in _prompts(cfg, k)
                for pg in range(PROMPT // PAGE_TOKENS)]
        tier, _ = asep.route(amap, torch.tensor(keys, dtype=torch.int64))
        tier = tier.tolist()
        lookups = [r for r in recs if r.name == "pool.lookup"
                   and _ancestor(r, ids, "serve.batch") is batch]
        assert [r.tags["tier"] for r in lookups] == tier
        assert {r.tags["keys"] for r in lookups} == {1}
        d = stats[k] - prev
        prev = stats[k]
        ext = sum(t == asep.EXTENDED for t in tier)
        want = (len(tier) - ext) + 3 * ext + 2 * (d.ext_false_pos
                                                  + d.ext_pred_miss)
        reads = [r for r in recs if r.name == "pool.readback"
                 and _ancestor(r, ids, "serve.batch") is batch]
        assert len(reads) == want
        for lk, t in zip(lookups, tier):
            n = len(_children(recs, lk))
            assert n == 1 if t == asep.CONVENTIONAL else n in (3, 5)
        writes = [r for r in recs if r.name == "pool.write"
                  and _ancestor(r, ids, "serve.batch") is batch]
        assert len(writes) == d.backing_fetches
        assert all(not _children(recs, w) for w in writes)


def _train(steps: int, traced: bool, device="cpu", arch="dense",
           cfg=None, batch=2, seq=16):
    cfg = cfg or configs.get(ARCHS[arch]).reduced()
    model = LM(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    opt = AdamW(learning_rate=1e-3)
    state = init_state(model, opt, gen)
    step = make_train_step(model, opt)
    rng = np.random.default_rng(1)
    batches = [torch.tensor(rng.integers(0, cfg.vocab_size, (batch, seq + 1)),
                            dtype=torch.int64, device=device)
               for _ in range(steps)]
    if traced:
        obs.enable(clock=time.time_ns, metrics=False)
    losses = []
    for t in batches:
        state, m = step(state, {"tokens": t[:, :-1], "targets": t[:, 1:]})
        losses.append(m["loss"].detach().clone())
    tracer = obs.tracer()
    obs.disable()
    return model, losses, tracer


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_step_spans_and_bit_identity(arch):
    m0, l0, _ = _train(2, False, arch=arch)
    t_lo = time.time_ns()
    m1, l1, tracer = _train(2, True, arch=arch)
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    for (n, a), (_, b) in zip(m0.named_parameters(), m1.named_parameters()):
        assert torch.equal(a, b), n
    recs = [r for r in tracer.records if r.name.startswith("train.")]
    ids = _by_id(tracer.records)
    steps = [r for r in recs if r.name == "train.step"]
    assert len(steps) == 2 and all(s.parent is None for s in steps)
    assert {s.tags["tokens"] for s in steps} == {2 * 16}
    for s in steps:
        assert [r.name for r in _children(recs, s)] == [
            "train.forward", "train.backward", "train.optimizer"]
    assert all(t_lo <= r.t0 <= r.t1 <= time.time_ns() for r in recs)
    # on the CPU no span records device edges
    assert all(r.edges is None and r.device_ms() is None for r in recs)
    if arch == "moe":
        # the MoE layer's spans in the forward, and again in the backward,
        # which recomputes each block
        moe = [r for r in tracer.records if r.name == "moe.dispatch"]
        under = [ids[r.parent].name for r in moe]
        assert set(under) == {"train.forward", "train.backward"}
        assert under.count("train.forward") == under.count("train.backward")


def test_tracer_records_beside_unchanged_events():
    """With a counting clock, the records hold the clock's integers, ids
    in opening order and parents by nesting; the Chrome events carry
    neither, as before."""
    ticks = iter(range(0, 1_000_000, 1_000))
    t = obs.Tracer(clock=lambda: next(ticks))
    with t.span("outer", layer="runtime"):
        with t.span("inner") as sp:
            sp.set(rows=4)
        with t.span("inner2").on_device(torch.device("cpu")):
            pass
    with t.span("outer"):
        pass
    assert [(r.name, r.t0, r.t1, r.id, r.parent) for r in t.records] == [
        ("inner", 1000, 2000, 2, 1), ("inner2", 3000, 4000, 3, 1),
        ("outer", 0, 5000, 1, None), ("outer", 6000, 7000, 4, None)]
    assert t.records[0].tags == {"rows": 4}
    assert all(set(e) == {"name", "ph", "ts", "dur", "pid", "tid", "args"}
               for e in t.to_chrome()["traceEvents"])
    assert obs.span("x").on_device(torch.device("cpu")) is obs.NULL_SPAN


# ---------------------------------------------------- on the card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device edges are CUDA events and "
                    "the model's kernels have no CPU mode there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_phase_edges_sum_to_the_step_on_the_card(cuda_device):
    """forward + backward + optimizer device ms within 2 % of the step's
    CUDA-event time, step by step, at a width that keeps the card busy."""
    cfg = dataclasses.replace(configs.get("qwen3-4b"), num_layers=2)
    _train(1, False, cuda_device, cfg=cfg, batch=2, seq=256)   # warm-up
    model = LM(cfg, device=cuda_device)
    opt = AdamW(learning_rate=1e-4)
    state = init_state(model, opt, torch.Generator(
        device=cuda_device).manual_seed(0))
    step = make_train_step(model, opt)
    tok = torch.randint(0, cfg.vocab_size, (2, 257), device=cuda_device)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    obs.enable(clock=time.time_ns, metrics=False)
    whole = []
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, _ = step(state, batch)
        e1.record()
        whole.append((e0, e1))
    torch.cuda.synchronize()
    recs = obs.tracer().records
    obs.disable()
    steps = [r for r in recs if r.name == "train.step"]
    assert len(steps) == 3
    for s, (e0, e1) in zip(steps, whole):
        total = e0.elapsed_time(e1)
        phases = [r for r in recs if r.parent == s.id]
        assert [r.name for r in phases] == [
            "train.forward", "train.backward", "train.optimizer"]
        got = sum(r.device_ms() for r in phases)
        assert abs(got - total) <= 0.02 * total, (got, total)
        assert abs(s.device_ms() - total) <= 0.02 * total


@pytest.mark.gpu
def test_decode_step_span_begins_before_its_first_kernel(cuda_device):
    """On the profiler's timeline, aligned to ``time.time_ns`` by a marker
    kernel on the idle card, the ``lm.decode_step`` span opens before the
    first kernel the step launches, and that kernel starts inside it.  The
    marker is launched once before the profiler starts: a process's first
    launch of it loads its module, which would delay the one measured."""
    from torch.profiler import ProfilerActivity, profile
    cfg = configs.get("qwen3-4b").reduced()
    model = LM(cfg, device=cuda_device).init_weights(
        torch.Generator(device=cuda_device).manual_seed(0))
    caches = model.init_caches(2, 24)
    tok = torch.randint(0, cfg.vocab_size, (2, 16), device=cuda_device)
    logits, caches = model.prefill({"tokens": tok}, caches)
    cur = logits.argmax(-1)
    model.decode_step(cur, caches, 16)            # warm
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.synchronize()
    anchor = time.time_ns()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    obs.enable(clock=time.time_ns, metrics=False)
    model.decode_step(cur, caches, 17)
    torch.cuda.synchronize()
    span = next(r for r in obs.tracer().records
                if r.name == "lm.decode_step")
    obs.disable()
    prof.stop()
    kernels = sorted((e.start_ns(), e.name()) for e in
                     prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA)
    marks = [s for s, n in kernels if "spin" in n.lower()]
    assert marks, "the marker kernel is not in the trace"
    shift = marks[0] - anchor
    after = [s for s, n in kernels if s > marks[0] and "spin" not in
             n.lower()]
    assert after, "no kernel of the decode step in the trace"
    assert span.t0 + shift <= after[0] <= span.t1 + shift, \
        (after[0] - span.t0, shift)
