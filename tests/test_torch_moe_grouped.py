"""The MoE layer's grouped experts (``repro_torch.kernels.moe`` and the
path that ``models.moe.moe_mlp`` chooses by ``grouped_path``).

On the CPU: the dispatch rule on device types, grad mode, token counts
and dtypes; ``grouped_experts``' argument checks; its plain version
against the segment loop (``models.moe._experts``) on one routing, with
drops forced by a small capacity; the launch and plain-run counts; and
``moe_mlp`` on the grouped path (the rule forced on) against the loop,
with its spans.  On a CUDA card only (marker ``gpu``): the kernel pair
against the plain version at deepseek-moe-16b's and jamba-1.5-large's
expert widths, and a traced decode step of reduced deepseek-moe-16b.
The grouped path against the reference's MoE layer is
``tests/test_torch_substrates.py::test_moe_mlp_grouped_path_matches_reference``.
This file imports no JAX, so the card host can run it:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_moe_grouped.py
"""
import dataclasses
import time

import pytest
import torch

from repro_torch import configs, obs
from repro_torch.kernels import moe as MK
from repro_torch.models import LM, seeded_numpy_params
from repro_torch.models import moe as MoE
from repro_torch.serving import Engine, Request

CUDA, CPU, META = (torch.device("cuda", 0), torch.device("cpu"),
                   torch.device("meta"))


@pytest.fixture(autouse=True)
def _clean():
    obs.disable()
    MK.reset_launches()
    yield
    obs.disable()


def _cfg(k: int, act: str = "silu", capacity: float = 0.25, e: int = 8):
    """Reduced deepseek-moe-16b with ``e`` experts, top-``k`` and a small
    capacity factor, so a call of many tokens drops pairs."""
    return dataclasses.replace(configs.get("deepseek-moe-16b").reduced(),
                               num_experts=e, top_k=k, act=act,
                               capacity_factor=capacity)


def _layer(cfg, t: int, seed: int = 0, device=CPU, dtype=torch.float32):
    """(expert weights, x2 (t, D), its routing) of one MoE layer of
    ``cfg``, drawn from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def draw(*shape, scale, dt=dtype):      # on the device, in place
        return torch.randn(*shape, generator=g, device=device,
                           dtype=dt).mul_(scale)
    p = {"router": draw(d, e, scale=d ** -0.5, dt=torch.float32),
         "w_gate": draw(e, d, f, scale=d ** -0.5),
         "w_up": draw(e, d, f, scale=d ** -0.5),
         "w_down": draw(e, f, d, scale=f ** -0.5)}
    x2 = draw(t, d, scale=1.0)
    return p, x2, MoE.route(p, x2, cfg)


def _loop(p, x2, r, cfg):
    key = torch.where(r.keep, r.expert, cfg.num_experts)
    return MoE._experts(p, x2, r, key, MoE.expert_counts(key, cfg), cfg)


def _grouped(p, x2, r, cfg):
    return MK.grouped_experts(x2, r.expert.contiguous(), r.weight, r.keep,
                              p["w_gate"], p["w_up"], p["w_down"], cfg.act)


@pytest.mark.parametrize("device, grad, tokens, dtype, taken", [
    (CUDA, False, 8, torch.float32, True),      # a decode step
    (CUDA, False, 1, torch.float32, True),
    (CUDA, False, 32, torch.bfloat16, True),    # the kernels' most rows
    (CUDA, True, 8, torch.float32, False),      # training: autograd
    (CUDA, False, 33, torch.float32, False),    # past the kernels' rows
    (CUDA, False, 8192, torch.float32, False),  # a prefill
    (CUDA, False, 0, torch.float32, False),
    (CUDA, False, 8, torch.float16, False),
    (META, False, 8, torch.float32, False),     # the op counter's shapes
    (CPU, False, 8, torch.float32, False),      # the reference tests' path
])
def test_dispatch_rule(device, grad, tokens, dtype, taken):
    cfg = configs.get("deepseek-moe-16b")
    with torch.set_grad_enabled(grad):
        assert MoE.grouped_path(device, tokens, dtype, cfg) is taken
        assert MoE.grouped_path(device, tokens, dtype, cfg.reduced()) \
            is taken


def test_dispatch_rule_on_the_pairs_and_widths():
    cfg = configs.get("deepseek-moe-16b")
    with torch.no_grad():
        assert MoE.grouped_path(CUDA, 32, torch.float32, cfg)
        assert not MoE.grouped_path(             # 32 x 17 pairs > 512
            CUDA, 32, torch.float32, dataclasses.replace(cfg, top_k=17))
        assert not MoE.grouped_path(
            CUDA, 8, torch.float32, dataclasses.replace(cfg, moe_d_ff=1407))


def _args(t=4, k=2, e=8, d=64, f=32, dtype=torch.float32):
    g = torch.Generator().manual_seed(1)
    return dict(x2=torch.randn(t, d, generator=g).to(dtype),
                expert=torch.randint(0, e, (t * k,), generator=g),
                weight=torch.rand(t * k, generator=g),
                keep=torch.ones(t * k, dtype=torch.bool),
                w_gate=torch.randn(e, d, f, generator=g).to(dtype),
                w_up=torch.randn(e, d, f, generator=g).to(dtype),
                w_down=torch.randn(e, f, d, generator=g).to(dtype),
                act="silu")


@pytest.mark.parametrize("change, error, match", [
    (dict(x2=torch.zeros(4, 64, 1)), ValueError, "x2 must be"),
    (dict(w_gate=torch.zeros(8, 64)), ValueError, "w_gate must be"),
    (dict(expert=torch.zeros(7, dtype=torch.int64)), ValueError, "T \\* k"),
    (dict(act="relu"), ValueError, "act"),
    (dict(expert=torch.zeros(8, dtype=torch.int32)), TypeError, "expert"),
    (dict(weight=torch.zeros(8, dtype=torch.float64)), TypeError, "weight"),
    (dict(keep=torch.ones(8, dtype=torch.uint8)), TypeError, "keep"),
    (dict(w_up=torch.zeros(8, 64, 30)), ValueError, "w_up"),
    (dict(w_down=torch.zeros(8, 64, 32)), ValueError, "w_down"),
    (dict(w_gate=torch.zeros(8, 64, 32, dtype=torch.float64)), TypeError,
     "w_gate"),
    (dict(w_down=torch.zeros(8, 64, 32).transpose(1, 2)), ValueError,
     "contiguous"),
])
def test_grouped_experts_checks_its_arguments(change, error, match):
    with pytest.raises(error, match=match):
        MK.grouped_experts(**{**_args(), **change})


@pytest.mark.parametrize("kw", [
    dict(t=33), dict(t=32, k=17), dict(d=63), dict(f=31),
    dict(dtype=torch.float16)])
def test_grouped_experts_refuses_what_the_kernels_do_not_take(kw):
    with pytest.raises(ValueError, match="the kernels take"):
        MK.grouped_experts(**_args(**kw))


def test_grouped_experts_has_no_kernel_on_meta():
    a = {n: v.to("meta") if isinstance(v, torch.Tensor) else v
         for n, v in _args().items()}
    with pytest.raises(ValueError, match="no kernel for device meta"):
        MK.grouped_experts(**a)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("t", [1, 8, 32])
@pytest.mark.parametrize("k", [1, 2, 6])
def test_plain_equals_the_segment_loop(act, t, k):
    """On one routing, the plain version equals ``_experts`` (the rows
    summed in another grouping, so within f32 rounding)."""
    cfg = _cfg(k, act)
    p, x2, r = _layer(cfg, t, seed=t * 10 + k)
    # a queue has 8 places and an expert at most a pair a token: past 8
    # tokens the small capacity drops pairs
    assert bool(r.keep.all()) == (t <= 8)
    want = _loop(p, x2, r, cfg)
    got = _grouped(p, x2, r, cfg)
    assert got.dtype == want.dtype and got.shape == (t, cfg.d_model)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    assert MK.plain_runs["grouped_experts"] == 1
    assert MK.launches["grouped_experts"] == 0


def test_plain_gives_zero_rows_to_tokens_whose_pairs_are_all_dropped():
    cfg = _cfg(2)
    p, x2, r = _layer(cfg, 4)
    keep = r.keep.clone()
    keep[:2] = False                    # token 0's two pairs
    got = MK.grouped_experts(x2, r.expert, r.weight, keep, p["w_gate"],
                             p["w_up"], p["w_down"], cfg.act)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert bool((got[1:] != 0).any(-1).all())


def test_counts_and_reset():
    a = _args()
    MK.grouped_experts(**a)
    MK.grouped_experts(**a)
    assert MK.plain_runs == {"grouped_experts": 2}
    assert MK.launches == {"grouped_experts": 0}
    MK.reset_launches()
    assert MK.plain_runs == MK.launches == {"grouped_experts": 0}


def test_op_counter_charges_the_kept_pairs_work():
    """Under an op counter the call is one charge: 6 D F FLOPs a kept
    pair and each expert hit's three matrices once, whatever runs."""
    from repro_torch.roofline import op_cost
    a = _args(t=4, k=2, e=8)
    a["keep"][3] = False
    kept = a["expert"][a["keep"]]
    cost = op_cost.analyze(MK.grouped_experts, **a)
    assert cost.by_name["grouped_experts"][:2] == [1, 6 * 64 * 32 * 7]
    assert cost.flops == 6 * 64 * 32 * 7
    hit = int(torch.unique(kept).numel())
    assert cost.bytes == 2 * 4 * 64 * 4 + 8 * 13 + hit * 3 * 64 * 32 * 4


def test_moe_mlp_on_the_cpu_takes_the_loop():
    cfg = _cfg(2)
    p, x2, _ = _layer(cfg, 3)
    with torch.no_grad():
        MoE.moe_mlp(p, x2, cfg)
    assert MK.plain_runs["grouped_experts"] == 0


@pytest.mark.parametrize("t", [3, 32])
def test_moe_mlp_on_the_grouped_path(monkeypatch, t):
    """With the rule forced on (the plain version standing in for the
    kernels), ``moe_mlp`` equals its loop, shared experts included, and
    its span holds ``moe.route`` and ``moe.grouped`` with no read-back."""
    cfg = dataclasses.replace(_cfg(2), num_shared_experts=1)
    p, x2, _ = _layer(cfg, t)
    p["shared"] = {n: torch.randn(*s, generator=torch.Generator()
                                  .manual_seed(5)) * 0.1
                   for n, s in (("w_gate", (64, 32)), ("w_up", (64, 32)),
                                ("w_down", (32, 64)))}
    with torch.no_grad():
        want = MoE.moe_mlp(p, x2.reshape(1, t, -1), cfg)
        monkeypatch.setattr(MoE, "grouped_path", lambda *a: True)
        obs.enable(clock=time.time_ns, metrics=False)
        got = MoE.moe_mlp(p, x2.reshape(1, t, -1), cfg)
    recs = obs.tracer().records
    obs.disable()
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    assert MK.plain_runs["grouped_experts"] == 1
    ids = {r.id: r for r in recs}
    top = next(r for r in recs if r.name == "moe.dispatch")
    assert sorted(r.name for r in recs if r.parent == top.id) == [
        "moe.grouped", "moe.route"]
    grouped = next(r for r in recs if r.name == "moe.grouped")
    assert grouped.tags == {"tokens": t, "pairs": t * cfg.top_k}
    assert ids[grouped.parent] is top
    assert not any(r.name in ("moe.readback", "moe.experts") for r in recs)


# ---------------------------------------------------- on the card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grouped kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return CUDA


def _full(arch: str, act: str = "silu"):
    return dataclasses.replace(configs.get(arch), act=act)


def _card_case(cfg, t: int, drop: bool, dtype=torch.float32):
    """(kernel output, plain output) on the card for ``t`` tokens of
    ``cfg`` at its full expert widths; ``drop`` forces a quarter of the
    pairs out."""
    with torch.no_grad():
        p, x2, r = _layer(cfg, t, seed=t + 100 * drop, device=CUDA,
                          dtype=dtype)
        keep = r.keep
        if drop:
            g = torch.Generator().manual_seed(t)
            keep = keep & (torch.rand(keep.shape, generator=g) > 0.25
                           ).to(CUDA)
        args = (x2, r.expert.contiguous(), r.weight, keep, p["w_gate"],
                p["w_up"], p["w_down"], cfg.act)
        got = MK.grouped_experts(*args)
        want = MK.grouped_experts_plain(*args)
        torch.cuda.synchronize()
    return got.float(), want.float()


def _row_err(got, want) -> float:
    """The largest row error over that row's largest |plain| (a row of a
    token whose pairs are all dropped is 0 on both sides)."""
    err = (got - want).abs().amax(-1)
    top = want.abs().amax(-1)
    assert bool((err[top == 0] == 0).all())
    return float((err[top > 0] / top[top > 0]).max())


@pytest.mark.gpu
@pytest.mark.parametrize("t, drop, act", [
    (1, False, "silu"), (1, True, "silu"), (8, False, "silu"),
    (8, True, "silu"), (16, False, "silu"), (16, True, "silu"),
    (32, False, "silu"), (32, True, "silu"), (8, True, "gelu")])
def test_kernels_at_deepseek_widths(cuda_device, t, drop, act):
    """64 experts of 2048 x 1408, top-6, f32: each row within 1e-5 of its
    largest value (the MoE card contract; f32 sums in another order)."""
    got, want = _card_case(_full("deepseek-moe-16b", act), t, drop)
    assert MK.launches["grouped_experts"] == 1
    assert _row_err(got, want) <= 1e-5


@pytest.mark.gpu
def test_kernels_at_jamba_widths(cuda_device):
    """16 experts of 8192 x 24576, top-2, f32 (38.7 GB of experts)."""
    got, want = _card_case(_full("jamba-1.5-large-398b"), 8,
                           True)
    assert _row_err(got, want) <= 1e-5


@pytest.mark.gpu
def test_kernels_in_bf16(cuda_device):
    """bf16 at deepseek's widths, rounded where the loop's cuBLAS calls
    round: a rounding of an intermediate can flip on sums taken in
    another order, so within a few bf16 ulps (2^-8 each) of the row."""
    got, want = _card_case(_full("deepseek-moe-16b"), 8, True,
                           torch.bfloat16)
    assert _row_err(got, want) <= 2e-2


@pytest.mark.gpu
def test_traced_decode_step_reads_back_once(cuda_device):
    """Reduced deepseek-moe-16b served on the card: each decode step reads
    back once (the sampler's), each MoE layer is one ``moe.grouped`` and
    one kernel launch, and no ``moe.experts`` or ``moe.readback`` runs."""
    cfg = configs.get("deepseek-moe-16b").reduced()
    eng = Engine(LM(cfg, device=cuda_device), seeded_numpy_params(cfg, 0),
                 max_len=40)
    gen = torch.Generator().manual_seed(0)
    reqs = [Request(i, torch.randint(0, cfg.vocab_size, (32,),
                                     generator=gen).tolist(), 4)
            for i in range(3)]
    obs.enable(clock=time.time_ns, metrics=False)
    eng.run(reqs)
    torch.cuda.synchronize()
    recs = obs.tracer().records
    obs.disable()
    moe_layers = sum(s.mlp == "moe" for s in eng.model.specs)
    assert moe_layers == cfg.num_layers - 1
    ids = {r.id: r for r in recs}

    def step_of(r):
        while r.parent is not None:
            r = ids[r.parent]
            if r.name == "serve.decode_step":
                return r.id
        return None
    under = {}
    for r in recs:
        under.setdefault(step_of(r), []).append(r.name)
    steps = [r.id for r in recs if r.name == "serve.decode_step"]
    ran = [s for s in steps if "lm.decode_step" in under.get(s, [])]
    assert len(ran) == 3                 # 4 tokens: the prefill's, 3 steps
    for s in steps:
        names = under.get(s, [])
        assert sum(n.endswith(".readback") for n in names) == 1
        assert names.count("moe.grouped") == moe_layers * (s in ran)
        assert "moe.experts" not in names and "moe.readback" not in names
    assert MK.launches["grouped_experts"] == len(ran) * moe_layers
