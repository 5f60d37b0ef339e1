"""The frozen work formulas and the FLOP counts at the cells' shapes,
against values worked out by hand."""
import json

import pytest

from conftest import BENCH
from work import flops, hw, kernels


def conf(name: str) -> dict:
    return json.load(open(BENCH / "configs" / f"{name}.json"))


def test_attended_pairs():
    assert kernels.attended_pairs(512, 512) == 512 * 513 // 2
    assert kernels.attended_pairs(1, 1040, q_start=1039) == 1040
    assert kernels.attended_pairs(4, 4, causal=False) == 16
    assert kernels.attended_pairs(6, 6, window=2) == 1 + 2 * 5


def test_flash_and_decode_work_at_the_serving_shapes():
    # qwen2-vl-7b prefill of 16 x 512: 28 query heads on 4 KV heads of 128
    n_bytes, ops = kernels.flash_work(16, 512, 512, 28, 4, 128, 128)
    assert ops == 2 * 16 * 28 * (512 * 513 // 2) * 256
    assert n_bytes == 4 * (16 * 512 * 28 * 128 * 2 + 16 * 512 * 4 * 256)
    # one decode step at position 600 of a 1040-slot cache, 8 rows, MHA 16
    n_bytes, ops = kernels.decode_work(8, 16, 16, 128, 1040, 8 * 601)
    assert ops == 4 * 8 * 601 * 16 * 128
    assert n_bytes == (4 * (8 * 16 * 128 + 2 * 8 * 601 * 16 * 128)
                       + 8 * 1040 + 8 * 16 * 128 * 4)
    b, o = kernels.flash_backward_work(1, 4096, 4096, 28, 4, 128, 128)
    f_b, f_o = kernels.flash_work(1, 4096, 4096, 28, 4, 128, 128)
    assert (b, o) == (2 * f_b, 2.5 * f_o)


def test_bound_is_the_larger_term():
    assert hw.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert hw.bound_s(1.0, 67e12) == pytest.approx(1.0)
    assert hw.bound_s(1.0, 989e12, "bfloat16") == pytest.approx(1.0)


def test_model_flops_of_the_cells():
    q = conf("qwen2-vl-7b")
    layer = (3584 * 3584 * 2 + 3584 * 512 * 2) + 3 * 3584 * 18944
    assert layer == 233_046_016
    assert flops.body_params(q) == 28 * layer
    head = 3584 * 152064
    attn = 28 * 4 * 16 * 28 * (512 * 513 // 2) * 128
    assert flops.prefill_flops(q, 16, 512) == (
        2 * 16 * 512 * 28 * layer + 2 * 16 * head + attn)
    assert flops.decode_flops(q, 16, 512) == (
        2 * 16 * (28 * layer + head) + 28 * 4 * 16 * 28 * 513 * 128)
    t = conf("qwen2-vl-7b-8l")
    assert flops.train_flops(t, 1, 4096) == 3 * (
        2 * 4096 * (8 * layer + head) + 8 * 4 * 28 * (4096 * 4097 // 2) * 128)
    d = conf("deepseek-moe-16b")
    attn_p = 4 * 2048 * 2048
    assert flops.layer_matmul_params(d, 0) == attn_p + 3 * 2048 * 10944
    assert flops.layer_matmul_params(d, 1) == (
        attn_p + 2048 * 64 + (6 + 2) * 3 * 2048 * 1408)
