"""On the card (the ``gpu`` marker; skipped without one): the control,
the plain reference computed in TF32, the precision below the
configurations' float32 with TF32 off, comes out not correct by the
cells' own limits, while the program's sound runs pass them, at the
cells' own size on three seeds.  ``calibrate.py check`` reads the same
numbers over a dozen seeds and more; the limits were set from them."""
import time

import pytest

from pbcore import cell, check, serve, train

SEEDS = (3_000_000_101, 3_000_000_102, 3_000_000_103)


def ctx_of(name, device, seed):
    return cell.Ctx(cell.load(name), seed, 10.0, False, device,
                    time.perf_counter())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen2vl7b.chat_prefix",
                                  "dsmoe16b.unique_docs"])
def test_serving_control_fails_its_limit(name, cuda_device):
    import calibrate
    from pbcore import program
    ctx = ctx_of(name, cuda_device, SEEDS[0])
    limits = ctx.limits
    server = serve.Server(ctx)
    try:
        for seed in SEEDS:
            program.load_weights(server.model, ctx.config, seed)
            out = calibrate.serve_seed(server, ctx._replace(seed=seed))
            assert all(out[k] <= v for k, v in limits.items()), (seed, out)
            assert out["token_mismatch"] == 0, (seed, out)
            assert any(out["control_" + k] > v
                       for k, v in limits.items()), (seed, out)
    finally:
        server.close()          # the model is 30-65 GB of the card


@pytest.mark.gpu
def test_training_control_fails_a_limit(cuda_device):
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    for seed in SEEDS:
        ctx = ctx_of("qwen2vl7b.train_4k", cuda_device, seed)
        model, state, step, prog = train.setup(ctx)
        del model, state, step
        gc.collect()
        torch.cuda.empty_cache()
        ref = check.reference_train(ctx)
        sound = check.compare_train(prog, ref)
        control = check.compare_train(
            check.reference_train(ctx, tf32=True), ref)
        keys = ("loss_gap", "grad_gap", "change_gap")
        assert all(sound[k] <= ctx.limits[k] for k in keys), sound
        assert any(control[k] > ctx.limits[k] for k in keys), control
