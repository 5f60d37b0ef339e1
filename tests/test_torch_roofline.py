"""The port's roofline analysis (``repro_torch.roofline``: ``hw``,
``analysis``, the op counter ``op_cost`` and the kernels' formulas
``kernel_work``) against the reference's (``repro.roofline``), on the
CPU.

Each test of ``tests/test_roofline.py`` has a mirror here, against the
op counter (a Python loop in place of ``lax.scan``: each trip is
dispatched, so no trip count is recovered).  Parity with the reference:

  * ``roofline_terms`` equals the reference's for the same constants and
    ``model_flops`` for all 40 cells;
  * the counter's FLOPs equal ``hlo_cost.analyze``'s exactly on the
    three mirrored programs;
  * on the reduced qwen3-4b's prefill, decode and training steps the
    FLOPs equal ``hlo_cost``'s exactly (tolerance 0) once the attention
    term is put on one footing: the reference's jnp ``_sdpa`` runs dense
    S x T dots (and its autodiff twice those in the backward), while the
    kernels' charge counts the pairs the masks let through (2.5 times
    the forward's in the backward), so the test swaps the kernels'
    charges for the dense dots;
  * the CPU count equals the ``meta`` count for all ten reduced configs'
    prefill and decode, an MoE layer's CPU router patched to the
    balanced router's segments that ``meta`` charges
    (``models.moe.balanced_counts``).

Bytes are held against hand counts only.  An eager program's bytes are
not XLA's fused ones: nothing is fused, so every intermediate is written
and read again, and the two counts are never compared."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as j_configs  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.roofline import hlo_cost  # noqa: E402
from repro.roofline import hw as j_hw  # noqa: E402
from repro.roofline.analysis import model_flops as j_model_flops  # noqa: E402
from repro.train import TrainState, make_train_step  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.kernels import attention as att  # noqa: E402
from repro_torch.kernels import engine_scan as scan  # noqa: E402
from repro_torch.kernels import pool as pool_ops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import LM, moe, params_from_numpy  # noqa: E402
from repro_torch.models import seeded_numpy_params  # noqa: E402
from repro_torch.roofline import (CHIP, H100, analysis,  # noqa: E402
                                  kernel_work, model_flops, op_cost,
                                  roofline_terms)

from torch_parity import one_torch_thread  # noqa: E402,F401

META = torch.device("meta")


def _compiled_text(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def meta(*shape):
    return torch.empty(shape, device=META)


# ------------------------------------------- mirrors of test_roofline.py

def test_single_matmul_flops():
    cost = op_cost.analyze(lambda a, b: a @ b, meta(256, 256),
                           meta(256, 256))
    assert cost.flops == 2 * 256 ** 3
    x = jax.ShapeDtypeStruct((256, 256), jnp.float32)
    assert cost.flops == hlo_cost.analyze(
        _compiled_text(lambda a, b: a @ b, x, x)).flops


def test_loop_multiplies_by_trip_count():
    def loop(x, ws):
        for w in ws:                 # seven trips, each dispatched
            x = x @ w
        return x

    cost = op_cost.analyze(loop, meta(128, 128), meta(7, 128, 128))
    assert cost.flops == 7 * 2 * 128 ** 3
    assert cost.by_name["aten.mm"][0] == 7

    def scanned(x, ws):
        y, _ = jax.lax.scan(lambda c, w: (c @ w, None), x, ws)
        return y

    assert cost.flops == hlo_cost.analyze(_compiled_text(
        scanned, jax.ShapeDtypeStruct((128, 128), jnp.float32),
        jax.ShapeDtypeStruct((7, 128, 128), jnp.float32))).flops


def test_nested_loops():
    def nested(x, ws):
        for w in ws:
            for _ in range(5):
                x = x @ w
        return x

    cost = op_cost.analyze(nested, meta(64, 64), meta(3, 64, 64))
    assert cost.flops == 3 * 5 * 2 * 64 ** 3

    def jnested(x, ws):
        def outer(c, w):
            c2, _ = jax.lax.scan(lambda c2, _: (c2 @ w, None), c, None,
                                 length=5)
            return c2, None
        y, _ = jax.lax.scan(outer, x, ws)
        return y

    assert cost.flops == hlo_cost.analyze(_compiled_text(
        jnested, jax.ShapeDtypeStruct((64, 64), jnp.float32),
        jax.ShapeDtypeStruct((3, 64, 64), jnp.float32))).flops


def test_bytes_scale_with_trip_count():
    def loop(x):
        for _ in range(11):
            x = x * 2.0 + 1.0
        return x

    cost = op_cost.analyze(loop, meta(1024, 1024))
    # each trip: two ops, each reading and writing the (1024, 1024) f32
    assert cost.bytes == 11 * 2 * 2 * 4 * 1024 * 1024
    assert cost.flops == 0


@pytest.fixture
def world_of_one():
    """An in-process gloo group of one rank (a ``HashStore``: no port)."""
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already initialised")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield dist
    dist.destroy_process_group()


def test_collectives_on_a_gloo_world_of_one(world_of_one):
    import torch.distributed._functional_collectives as fc
    x = torch.ones(1024, 256)

    def prog(x):
        y = fc.wait_tensor(fc.all_reduce(x, "sum", world_of_one.group.WORLD))
        return fc.wait_tensor(fc.all_to_all_single(
            y, None, None, world_of_one.group.WORLD))

    cost = op_cost.analyze(prog, x)
    b = 1024 * 256 * 4
    assert cost.collective_bytes == 2 * b
    assert analysis.collective_bytes(cost) == (
        2 * b, {"all-reduce": b, "all-to-all": b})
    assert analysis.collective_op_counts(cost) == {
        "all-reduce": 1, "all-gather": 0, "reduce-scatter": 0,
        "all-to-all": 1, "collective-permute": 0}


def test_roofline_terms_dominance():
    t = roofline_terms(flops=67e12 * 4, bytes_hbm=1.0, bytes_collective=1.0,
                       chips=4)
    assert t["dominant"] == "compute" and abs(t["t_compute_s"] - 1.0) < 1e-9
    t = roofline_terms(flops=989e12, bytes_hbm=1.0, bytes_collective=1.0,
                       chips=1, dtype=torch.bfloat16)
    assert t["dominant"] == "compute" and abs(t["t_compute_s"] - 1.0) < 1e-9
    t = roofline_terms(flops=1.0, bytes_hbm=3.35e12 * 4,
                       bytes_collective=1.0, chips=4)
    assert t["dominant"] == "memory" and abs(t["t_memory_s"] - 1.0) < 1e-9
    t = roofline_terms(flops=1.0, bytes_hbm=1.0,
                       bytes_collective=25e9 * 18 * 4, chips=4)
    assert t["dominant"] == "collective"


# ------------------------------------------------ parity with the reference

@pytest.mark.parametrize("flops,bytes_hbm,coll,chips", [
    (197e12 * 256, 1.0, 1.0, 256), (1.0, 819e9 * 256, 1.0, 256),
    (1.0, 1.0, 50e9 * 4 * 256, 256), (3.1e15, 7.7e12, 2.2e11, 16),
    (0.0, 0.0, 0.0, 1)])
def test_roofline_terms_equal_the_references(flops, bytes_hbm, coll, chips):
    """The same formula: an ``H100`` record holding the reference's TPU
    constants gives the reference's terms, bf16 work at its bf16 peak."""
    ref = j_hw.TPUChip()
    chip = H100(peak_flops_bf16=ref.peak_flops_bf16, hbm_Bps=ref.hbm_Bps,
                nvlink_Bps_per_link=ref.ici_Bps_per_link,
                nvlink_links=ref.ici_links)
    kw = dict(flops=flops, bytes_hbm=bytes_hbm, bytes_collective=coll,
              chips=chips)
    assert roofline_terms(**kw, chip=chip, dtype=torch.bfloat16) == \
        j_hw.roofline_terms(**kw)


def test_h100_constants():
    assert (CHIP.peak_flops(torch.float32), CHIP.peak_flops(torch.bfloat16),
            CHIP.hbm_Bps, CHIP.hbm_bytes) == (67e12, 989e12, 3.35e12, 80e9)
    assert CHIP.nvlink_Bps_per_link * CHIP.nvlink_links == 450e9


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a, s, _ in t_configs.cells(include_skipped=True)])
def test_model_flops_equal_the_references(arch, shape):
    assert model_flops(t_configs.get(arch), t_configs.SHAPES[shape]) == \
        j_model_flops(j_configs.get(arch), j_configs.SHAPES[shape])


def dense_footing(cost, b: int, s: int, t: int, h: int, hd: int) -> float:
    """The count's FLOPs with the kernels' attention charges swapped for
    the reference's dense dots: QK^T and PV over all S x T pairs forward
    (a decode: the whole cache), twice those in a backward."""
    dense = 2 * b * h * s * t * (hd + hd)
    flops = cost.flops
    for name, per_call in (("flash_attention", dense),
                           ("decode_attention", dense),
                           ("flash_attention_backward", 2 * dense)):
        calls, charged, _ = cost.by_name.get(name, (0, 0.0, 0.0))
        flops += calls * per_call - charged
    return flops


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_lm_step_flops_equal_hlo_cost(kind):
    """The reduced qwen3-4b, counted on ``meta`` and by ``hlo_cost`` over
    the reference's compiled step: equal (tolerance 0) on one footing."""
    jcfg, tcfg = (m.get("qwen3-4b").reduced() for m in (j_configs,
                                                          t_configs))
    b, s, max_len = 2, 16, 24
    jm = j_tf.LM(jcfg)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    i32 = jnp.int32
    tokens = jax.ShapeDtypeStruct((b, s), i32)
    caches = jax.eval_shape(lambda: jm.init_caches(b, max_len))
    model = LM(tcfg, device=META)
    ttok = torch.empty((b, s), dtype=torch.int32, device=META)
    h, hd = tcfg.num_heads, tcfg.resolved_head_dim
    if kind == "prefill":
        text = _compiled_text(jm.prefill, params, {"tokens": tokens}, caches)
        cost = D.count_prefill(model, {"tokens": ttok},
                               model.init_caches(b, max_len))
        got = dense_footing(cost, b, s, s, h, hd)
    elif kind == "decode":
        text = _compiled_text(jm.decode_step, params,
                              jax.ShapeDtypeStruct((b,), i32), caches,
                              jax.ShapeDtypeStruct((), i32))
        cost = D.count_decode(model, ttok[:, 0].contiguous(),
                              model.init_caches(b, max_len), s)
        got = dense_footing(cost, b, 1, max_len, h, hd)
    else:
        opt = JAdamW()
        state = TrainState(params=params,
                           opt=jax.eval_shape(opt.init, params), comp=None)
        text = _compiled_text(make_train_step(jm, opt), state,
                              {"tokens": tokens, "targets": tokens})
        cost = D.count_train(model, {"tokens": ttok, "targets": ttok})
        got = dense_footing(cost, b, s, s, h, hd)
    assert got == hlo_cost.analyze(text).flops
    assert cost.flops < got               # the masks let fewer pairs through


def step_counts(model, dev, cfg, b=2, s=12, max_len=24):
    """(prefill, decode) counts of ``model`` on ``dev`` (inputs from a
    numpy seed: only their shapes matter on ``meta``)."""
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).to(dev)
    batch = {"tokens": tokens}
    if cfg.is_encdec:
        batch["frame_embeds"] = torch.zeros((b, 8, cfg.d_model), device=dev)
    caches = model.init_caches(b, max_len)
    pre = D.count_prefill(model, batch, caches)
    dec = D.count_decode(model, tokens[:, 0].contiguous(), caches, s)
    return pre, dec


@pytest.mark.parametrize("arch", list(t_configs.ALL_ARCHS))
def test_cpu_count_equals_the_meta_count(arch, monkeypatch):
    """The plain versions on the CPU and nothing on ``meta`` charge the
    same FLOPs and bytes: the kernels by formula, every other op the
    same.  An MoE layer's segments depend on its router's data, so on the
    CPU they are patched to the balanced router's that ``meta`` charges
    (``test_moe_on_meta_charges_a_balanced_router``)."""
    cfg = t_configs.get(arch).reduced()
    monkeypatch.setattr(moe, "expert_counts", lambda key, c:
                        moe.balanced_counts(key.numel() // c.top_k, c))
    cpu = LM(cfg, device="cpu")
    params_from_numpy(cpu, seeded_numpy_params(cfg, 0))
    att.reset_launches()
    for got, want in zip(step_counts(cpu, "cpu", cfg),
                         step_counts(LM(cfg, device=META), META, cfg)):
        assert (got.flops, got.bytes) == (want.flops, want.bytes)
        assert got.flops > 0
    attends = any(sp.mixer != "mamba"
                  for sp in cfg.prefix_layers + cfg.block_pattern)
    assert (att.plain_runs["flash_attention"] > 0) == attends


def test_moe_on_meta_charges_a_balanced_router():
    cfg = dataclasses.replace(t_configs.get("deepseek-moe-16b").reduced(),
                              capacity_factor=1.25)
    counts = moe.balanced_counts(20, cfg)
    assert len(counts) == cfg.num_experts + 1
    assert sum(counts) == 20 * cfg.top_k
    assert max(counts[:-1]) <= moe._capacity(20, cfg)
    assert max(counts[:-1]) - min(counts[:-1]) <= 1
    key = torch.empty((20 * cfg.top_k,), dtype=torch.int64, device=META)
    assert moe.expert_counts(key, cfg) == counts
    key = torch.tensor([0, 2, 2, cfg.num_experts])
    assert moe.expert_counts(key, cfg) == (
        [1, 0, 2] + [0] * (cfg.num_experts - 3) + [1])


# ---------------------------------------------------- the counter's rules

@pytest.mark.parametrize("s,t,causal,window", [
    (64, 64, True, 0), (64, 64, True, 8), (48, 80, False, 0),
    (80, 48, True, 0), (33, 70, False, 5), (16, 16, True, 1)])
def test_attended_pairs_count_the_mask(s, t, causal, window):
    i = torch.arange(s)[:, None]
    j = torch.arange(t)[None, :]
    mask = (j <= i) if causal else torch.ones((s, t), dtype=torch.bool)
    if window:
        mask = mask & (i - j < window)
    assert kernel_work.attended_pairs(s, t, causal, window) == int(mask.sum())


def test_hand_counted_bytes():
    """Views are free; ``copy_`` into a slice charges the update read and
    the slice written; ``index_put_`` twice the update; a gather twice
    what it reads; a fill its output."""
    buf, upd = meta(64, 32), meta(4, 32)
    idx = torch.empty((4,), dtype=torch.int64, device=META)

    def prog(buf, upd, idx):
        v = buf.view(32, 64).t().reshape(64, 32)[2:6]     # views only
        v.copy_(upd)
        buf[idx] = upd
        g = buf[idx]
        z = torch.zeros(8, 8, device=META)
        return g, z

    cost = op_cost.analyze(prog, buf, upd, idx)
    u = 4 * 32 * 4
    assert cost.by_name == {"aten.copy_": [1, 0.0, 2 * u],
                            "aten.index_put_": [1, 0.0, 2 * u],
                            "aten.index": [1, 0.0, 2 * u],
                            "aten.zeros": [1, 0.0, 8 * 8 * 4]}
    assert cost.argument_bytes == 64 * 32 * 4 + u + 4 * 8


def test_temp_bytes_are_the_peak_of_live_intermediates():
    def prog(x):
        a = x * 2.0           # 4 KiB alive
        b = a + 1.0           # 8 KiB alive
        del a
        c = b * b             # 8 KiB alive again
        return c.sum()        # and its 4 bytes

    cost = op_cost.analyze(prog, meta(1024))
    assert cost.temp_bytes == 2 * 4096 + 4
    assert analysis.memory_stats(cost)["temp_size_in_bytes"] == 2 * 4096 + 4
    assert analysis.cost_dict(cost) == {"flops": 0.0,
                                        "bytes accessed": cost.bytes}


def test_kernel_charges_suspend_the_plain_version():
    """On the CPU the flash wrapper's plain version materialises the
    scores; the counter sees its formula alone, the same as on
    ``meta``."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, np.float32))
               for sh in ((2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    kw = dict(causal=True, window=8)
    cpu = op_cost.analyze(lambda *a: att.flash_attention(*a, **kw), q, k, v)
    on_meta = op_cost.analyze(lambda *a: att.flash_attention(*a, **kw),
                              *(x.to(META) for x in (q, k, v)))
    work = kernel_work.attention_work("flash_attention", (q, k, v), kw)
    assert cpu.by_name == on_meta.by_name == {
        "flash_attention": [1, work.ops, work.bytes]}
    assert work.ops == 2 * 2 * 4 * kernel_work.attended_pairs(
        40, 40, True, 8) * (16 + 16)


def test_pool_and_scan_wrappers_charge_their_formulas():
    """The pool's and the engine's wrappers charge ``pool_work`` and
    ``scan_work`` of their arguments, nothing of their plain versions."""
    from repro_torch.core import address_separation as asep
    from repro_torch.core import controller as ctl
    from repro_torch.core import engine
    rng = np.random.default_rng(0)
    tags = torch.from_numpy(rng.integers(0, 99, (64, 8)).astype(np.int32))
    valid = torch.from_numpy(rng.random((64, 8)) < 0.5)
    req = torch.from_numpy(rng.integers(0, 99, 64).astype(np.int32))
    args = (tags, valid, tags.clone(), req)
    cost = op_cost.analyze(lambda *a: pool_ops.tag_lookup(*a), *args)
    w = kernel_work.pool_work("tag_lookup", args)
    assert cost.by_name == {"tag_lookup": [1, w.ops, w.bytes]}

    amap = asep.make_map(conv_sets=16, num_cache_chips=3, sets_per_chip=5)
    cfg = ctl.MorpheusConfig(amap=amap, conv_ways=4, ext_ways=4)
    tr = [(rng.integers(0, 4096, size=300).astype(np.uint32),
           rng.random(300) < 0.3, rng.integers(0, 3, 300).astype(np.int32),
           0)]
    pt = engine.to_device(engine.pack(cfg, tr), "cpu")
    cols = (pt.conv_tag, pt.conv_write, pt.conv_active, pt.conv_active)
    cost = op_cost.analyze(lambda *a: scan.conv_scan(cfg, *a), *cols)
    w = kernel_work.scan_work("conv", cols[:3], cfg.conv_ways)
    assert cost.by_name == {"conv_scan": [1, w.ops, w.bytes]}
    assert w.ops == int(pt.conv_active.sum()) * 4 * cfg.conv_ways


def test_charges_do_nothing_without_a_counter():
    """Outside every counter a wrapper's charge evaluates no work (the
    hot paths pay one check of the active count); inside one it
    charges."""
    calls = []

    def work(_=None):
        calls.append(1)
        return kernel_work.Work(ops=3, bytes=5)

    plus_one = op_cost.charged(work)(lambda x: x + 1)
    assert op_cost._ACTIVE == 0
    with op_cost.charge("k", work):
        pass
    assert plus_one(1) == 2 and calls == []
    with op_cost.OpCounter() as counter:
        assert op_cost._ACTIVE == 1
        assert plus_one(1) == 2
    assert op_cost._ACTIVE == 0 and calls == [1]
    assert counter.cost.by_name == {"<lambda>": [1, 3, 5]}
