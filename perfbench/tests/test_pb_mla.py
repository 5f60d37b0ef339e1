"""A configuration of latent-attention layers (``"layout": "mla"``) is
drawn, built, served and checked by the files that are there: at a tiny
width on the CPU, the program's MLA ``LM`` (prefill on decompressed
heads, the absorbed decode through the engine and its pool) against
``reference/mla.py``.  No cell of ``BENCHMARK.json`` is MLA, so the cell
here is the document cell with its configuration replaced."""
import json
import time

import pytest
import torch

import calibrate
from conftest import TINY_MIX
from layouts import mla
from pbcore import cell, check, program, readings, serve
from pbcore import weights as W
from reference import mla as R
from work import flops

SEED = 2 ** 35 + 9
TINY_MLA = {
    "name": "tiny-mla", "repo_config": "deepseek-v2-lite-16b",
    "layout": "mla", "reference": "mla", "dtype": "float32", "tf32": False,
    "d_model": 64, "num_layers": 3, "num_heads": 4, "num_kv_heads": 4,
    "kv_lora_rank": 16, "qk_rope_dim": 8, "qk_nope_dim": 16,
    "v_head_dim": 16, "d_ff": 128, "vocab_size": 512, "rope_theta": 10000.0,
    "norm_eps": 1e-06, "act": "silu", "tie_embeddings": False,
    "num_experts": 8, "first_dense_layers": 1, "top_k": 2,
    "num_shared_experts": 1, "moe_d_ff": 32, "capacity_factor": 1.25,
}
# DeepSeek-V2-Lite's published sizes, for the counts by hand
LITE = dict(TINY_MLA, d_model=2048, num_layers=27, num_heads=16,
            kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128,
            v_head_dim=128, d_ff=10944, vocab_size=102400, num_experts=64,
            top_k=6, num_shared_experts=2, moe_d_ff=1408)


def mla_ctx(traffic: str = "dsmoe16b.unique_docs", trace: bool = False
            ) -> cell.Ctx:
    torch.manual_seed(0)
    c = cell.load(traffic)
    m = dict(json.loads(json.dumps(c.mix)), **TINY_MIX[c.traffic])
    return cell.Ctx(c._replace(config=dict(TINY_MLA), mix=m), SEED, 1.0,
                    trace, torch.device("cpu"), time.perf_counter())


def test_every_parameter_is_a_drawn_leaf():
    cfg, cpu = TINY_MLA, torch.device("cpu")
    model = program.build_model(cfg, SEED, cpu)
    params = program.leaf_params(model)
    drawn = {f"layers.{li}.{k}": v for li in range(cfg["num_layers"])
             for k, v in W.draw_layer(cfg, SEED, li, cpu).items()}
    drawn.update(W.draw_top(cfg, SEED, cpu))
    assert set(params) == set(drawn)
    shapes = {f"layers.{li}.{lf.name}": lf.shape
              for li in range(cfg["num_layers"])
              for lf in mla.layer_leaves(cfg, li)}
    for n, p in params.items():
        if n.startswith("layers."):
            assert tuple(p.shape) == shapes[n], n
        assert torch.equal(p.detach(), drawn[n]), n
    assert {n.split(".", 2)[2] for n in shapes if "mixer" in n} == {
        "mixer.wq", "mixer.w_dkv", "mixer.kv_norm", "mixer.w_ukv",
        "mixer.wo"}


def test_forward_logits():
    cfg, cpu = TINY_MLA, torch.device("cpu")
    model = program.build_model(cfg, SEED, cpu)
    tokens = torch.randint(0, cfg["vocab_size"], (3, 24),
                           generator=torch.Generator().manual_seed(1))
    got = model({"tokens": tokens})
    want = R.forward_logits(cfg, W.draw_top(cfg, SEED, cpu),
                            lambda li: W.draw_layer(cfg, SEED, li, cpu),
                            tokens)
    assert torch.allclose(got, want, atol=1e-4 * float(want.abs().max()))


def test_served_batches():
    """Prefill, then the program's absorbed decode through the engine and
    its pool, against the reference over the prompt and the served
    tokens, the MoE calls the server's."""
    ctx = mla_ctx()
    out = calibrate.serve_seed(serve.Server(ctx), ctx)
    assert out["served_gap"] == 0.0
    assert out["token_mismatch"] == 0
    assert out["logit_err_max"] < 1e-5
    assert out["tokens"] >= ctx.mix["check_tokens"]


def test_a_run_is_correct_and_read():
    ctx = mla_ctx(trace=True)
    rec = cell.run(ctx)
    out = cell.result(ctx, rec)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert readings.round_mfu(rec) > 0


def test_decode_that_skips_writing_k_rope_fails(monkeypatch):
    """Each decode step writes its token's latent and not its RoPE key:
    the later steps read a key of zeros there."""
    from repro_torch.models import attention
    orig = attention._mla_decode

    def decode(p, x, cache, *a, **k):
        kept = dict(cache, k_rope=cache["k_rope"].clone())
        return orig(p, x, kept, *a, **k)
    monkeypatch.setattr(attention, "_mla_decode", decode)
    ctx = mla_ctx()
    out = cell.result(ctx, cell.run(ctx))
    assert not out["correct"]
    c = out["checks"]["logit_err"]
    assert c["value"] > c["limit"]


def test_work_by_hand():
    attn = (2048 * 16 * (128 + 64) + 2048 * (512 + 64)
            + 512 * 16 * (128 + 128) + 16 * 128 * 2048)
    assert attn == 13_762_560
    assert flops.layer_matmul_params(LITE, 0) == attn + 3 * 2048 * 10944
    assert flops.layer_matmul_params(LITE, 1) == (
        attn + 2048 * 64 + (6 + 2) * 3 * 2048 * 1408)
    pairs = 8 * (1024 * 1025 // 2)
    assert flops.attention_flops(LITE, 8, 1024, 1024) == 27 * (
        2 * pairs * 16 * (128 + 64) + 2 * pairs * 16 * 128)
    assert flops.attention_flops(LITE, 8, 1, 1040, 1039) == 27 * (
        2 * 8 * 1040 * 16 * 192 + 2 * 8 * 1040 * 16 * 128)
    assert readings._attn(LITE) == mla.attn_shape(LITE) == (16, 16, 192, 128)


def test_arch_of_takes_the_layouts_keys():
    arch = program.arch_of(LITE)
    assert arch.mla and (arch.kv_lora_rank, arch.qk_rope_dim,
                         arch.qk_nope_dim, arch.v_head_dim) == (512, 64, 128,
                                                                128)
    with pytest.raises(ValueError, match="kv_lora_rank"):
        program.arch_of({k: v for k, v in LITE.items()
                         if k != "kv_lora_rank"})


def test_a_training_mix_stops_with_a_clear_error():
    ctx = mla_ctx("qwen2vl7b.train_4k")
    with pytest.raises(NotImplementedError, match="no training step"):
        check.reference_train(ctx)
