"""The plain reference agrees with the program's CPU path (its kernels'
plain versions) on the benchmark's seeded weights, for both
architectures cut to a tiny width: the logits of a forward and of a
served batch (prefill, then decode through the cache), the loss and
every gradient, and the readings of the checked training steps.  The
test imports the program; the reference does not."""
import time

import pytest
import torch

from conftest import tiny_ctx
from pbcore import check, program, serve, train
from pbcore import weights as W
from reference import transformer as R

SEED = 2 ** 35 + 3


@pytest.mark.parametrize("name", ["qwen2vl7b.chat_prefix",
                                  "dsmoe16b.unique_docs"])
def test_forward_logits(name):
    ctx = tiny_ctx(name)
    cfg, cpu = ctx.config, torch.device("cpu")
    model = program.build_model(cfg, SEED, cpu)
    tokens = torch.randint(0, cfg["vocab_size"], (3, 24),
                           generator=torch.Generator().manual_seed(1))
    got = model({"tokens": tokens})
    want = R.forward_logits(cfg, W.draw_top(cfg, SEED, cpu),
                            lambda li: W.draw_layer(cfg, SEED, li, cpu),
                            tokens)
    assert torch.allclose(got, want, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("name", ["qwen2vl7b.chat_prefix",
                                  "dsmoe16b.unique_docs"])
def test_served_batches(name):
    """Prefill and decode through the engine against the reference over
    the prompt and the served tokens, the MoE calls the server's."""
    import calibrate
    ctx = tiny_ctx(name, seed=SEED)
    server = serve.Server(ctx)
    out = calibrate.serve_seed(server, ctx)
    assert out["served_gap"] == 0.0
    assert out["token_mismatch"] == 0
    assert out["logit_err_max"] < 1e-5
    assert out["tokens"] >= ctx.mix["check_tokens"]


def test_loss_and_gradients():
    ctx = tiny_ctx("qwen2vl7b.train_4k")
    cfg, cpu = ctx.config, torch.device("cpu")
    model = program.build_model(cfg, SEED, cpu).requires_grad_(True)
    from pbcore import traffic
    batch = traffic.train_batch(ctx.mix, cfg["vocab_size"], SEED, 0, cpu)
    loss = model.loss(batch)
    params = program.leaf_params(model)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    ref_params = {f"layers.{li}.{k}": v for li in range(cfg["num_layers"])
                  for k, v in W.draw_layer(cfg, SEED, li, cpu).items()}
    ref_params.update(W.draw_top(cfg, SEED, cpu))
    ref = R.TrainReference(cfg, ctx.mix["optimizer"], ref_params)
    ref_loss = ref.loss(batch)
    ref_grads = dict(zip(ref.params, torch.autograd.grad(
        ref_loss, list(ref.params.values()))))
    assert abs(float(loss) - float(ref_loss)) < 1e-5 * abs(float(ref_loss))
    assert set(grads) == set(ref_grads)
    for n, g in grads.items():
        tol = 1e-4 * float(ref_grads[n].abs().max()) + 1e-7
        assert torch.allclose(g, ref_grads[n], atol=tol), n


def test_checked_training_steps():
    ctx = tiny_ctx("qwen2vl7b.train_4k", seed=SEED)
    *_, prog = train.setup(ctx)
    r = check.compare_train(prog, check.reference_train(ctx))
    assert r["loss_gap"] < 1e-6
    assert r["grad_gap"] < 1e-5
    assert r["change_gap"] < 1e-5
    assert r["left_out"] == 0
