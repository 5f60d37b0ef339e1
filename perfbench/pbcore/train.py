"""A training cell: the step of the program's ``train_step.
make_train_step`` (AdamW as the mix states it, each block recomputed in
the backward) on the model of the configuration, fed a new batch of the
mix each step.

Set-up builds the one step object, drives it through the checked steps
(``check.CHECKED_STEPS``) and reads what the comparison needs: each
step's loss, the first moment after step 1 (the first gradient as the
optimizer took it) and the parameters after the last checked step.  The
window then runs the same object on, one step after another, until it
closes; the rate is the tokens of all its steps over the time to the end
of the last.  ``--trace 1`` profiles ``TRACED_STEPS`` more steps after
the window.
"""
from __future__ import annotations

import gc
import math
import time

import torch

from . import check, program, traffic
from .trace import DeviceTrace, Spans, syncer

TRACED_STEPS = 2


def _first_grads(state, params: dict, b1: float) -> dict:
    """Each leaf's norm of the first gradient as AdamW took it: its first
    moment after one step over (1 - b1)."""
    from repro_torch.pytree import leaves
    moment = {}
    for p_leaf, m_leaf in zip(leaves(state.params), leaves(state.opt.mu)):
        for p, m in zip(p_leaf.parts, m_leaf.parts):
            moment[id(p)] = m
    return {n: float(torch.linalg.vector_norm(moment[id(p)])) / (1 - b1)
            for n, p in params.items()}


def setup(ctx):
    """The step object of the cell, driven through the checked steps:
    (model, state, step, the program's readings for the check)."""
    from repro_torch.optim import AdamW
    from repro_torch.train.train_step import init_state, make_train_step
    cfg, mix, dev, seed = ctx.config, ctx.mix, ctx.device, ctx.seed
    o = mix["optimizer"]
    model = program.build_model(cfg, seed, dev)
    opt = AdamW(learning_rate=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                weight_decay=o["weight_decay"], clip_norm=o["clip_norm"])
    state = init_state(model, opt)
    step = make_train_step(model, opt, remat=mix["remat"])
    params = program.leaf_params(model)
    prog = {"losses": []}
    for k in range(check.CHECKED_STEPS):
        state, m = step(state, traffic.train_batch(mix, cfg["vocab_size"],
                                                   seed, k, dev))
        prog["losses"].append(float(m["loss"]))
        if k == 0:
            prog["grad_norms"] = _first_grads(state, params, o["b1"])
    prog["change_norms"] = check.change_norms(params, cfg, seed, dev)
    return model, state, step, prog


def run(ctx) -> dict:
    cfg, mix, dev, seed = ctx.config, ctx.mix, ctx.device, ctx.seed
    vocab, sync = cfg["vocab_size"], syncer(dev)
    model, state, step, prog = setup(ctx)
    sync()
    setup_s = time.perf_counter() - ctx.t_start

    k = check.CHECKED_STEPS
    t0 = time.perf_counter()
    close = t0 + ctx.seconds
    while time.perf_counter() < close:
        state, m = step(state, traffic.train_batch(mix, vocab, seed, k, dev))
        k += 1
    last_loss = float(m["loss"]) if k > check.CHECKED_STEPS else math.nan
    sync()
    elapsed = time.perf_counter() - t0
    steps = k - check.CHECKED_STEPS

    summary = None
    if ctx.trace:
        spans = Spans(dev)
        spans.wrap(model, "loss", "train.forward", sync=False)
        dt = DeviceTrace(dev)
        spans.keep = True
        dt.start()
        for _ in range(TRACED_STEPS):
            w0 = time.time_ns()
            state, m = step(state, traffic.train_batch(mix, vocab, seed, k,
                                                       dev))
            k += 1
            spans.mark("train.step", w0, time.time_ns())
        dt.stop()
        summary = dt.summary(spans.intervals)
        if summary is not None:
            summary["steps"] = TRACED_STEPS
        spans.unwrap()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    del state, step, model, m
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec = {
        "kind": "train", "config": cfg, "mix": mix, "setup_s": setup_s,
        "memory_peak_bytes": int(peak), "attempted": steps,
        "failed": 0 if math.isfinite(last_loss) else steps,
        "steps": steps, "tokens": steps * mix["batch"] * mix["seq"],
        "elapsed_s": elapsed, "trace": summary, "spans": {}}
    rec["checks"] = check.trained(ctx, prog)
    return rec
