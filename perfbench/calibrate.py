#!/usr/bin/env python3
"""Readings that set a cell's limits and rates, on the card, at the
cell's own size; the benchmark's runs never run this.

    python3 perfbench/calibrate.py check --workload <cell> --seeds 1,2,3 \
        [--faults 1,2]
    python3 perfbench/calibrate.py sweep --workload <cell> --seed <n> \
        --seconds <s> --rates 2,3,4 [--backlog <n>] [--drain 0|1]

``check`` reads, seed by seed in one process, what the comparison reads
of sound runs of the program and of the control (the reference computed
in TF32, the precision below the configuration's), and with ``--faults``
of the faults planted in the program: for serving a token altered where
the sampler produces it, a decode step whose cache never advances, and
a decode step that feeds the batch's last slot another token than the
one it served (a fault of one slot);
for training half of each batch left out (a step that returns its state
unchanged reads 1 by the comparison's measure and needs no run).  A serving seed reads the quantiles of the logit error, every
request's median and the widest gap of the served tokens too.
``sweep`` offers the mix at each rate for a window and reports what the
server sustained.  One JSON object a reading goes to standard output.
"""
import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import torch  # noqa: E402

from pbcore import cell, check, program, serve, traffic, train  # noqa: E402
from pbcore import weights as W  # noqa: E402


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def serve_seed(server, ctx, fault: str = "") -> dict:
    """Full batches of the seed's traffic served, then read against the
    reference (and the control)."""
    mix, cfg = ctx.mix, ctx.config
    b = mix["max_batch"]
    n = math.ceil(mix["check_tokens"] / (b * mix["new_tokens"]))
    reqs = traffic.serve_requests(mix, cfg["vocab_size"], ctx.seed, 60.0)
    from repro_torch.serving import sampler
    model, plen = server.model, mix["prompt_tokens"]
    decode, greedy = model.decode_step, sampler.greedy

    def bad_greedy(logits):         # row 0's token moved to the next one
        tok = greedy(logits).clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok

    def stale_decode(tokens, caches, cur_pos):
        return decode(tokens, caches, plen)

    def slot_decode(tokens, caches, cur_pos):
        return decode(last_slot_altered(tokens, cfg["vocab_size"]), caches,
                      cur_pos)
    if fault == "token":
        sampler.greedy = bad_greedy
    elif fault == "stale":
        model.decode_step = stale_decode
    elif fault == "slot":
        model.decode_step = slot_decode
    try:
        rounds = [server.serve(reqs[k * b:(k + 1) * b]) for k in range(n)]
    finally:
        model.decode_step, sampler.greedy = decode, greedy
    return check.serve_readings(ctx, rounds, tf32=not fault)


def last_slot_altered(tokens, vocab: int):
    """The decode step's input with the batch's last row moved to the next
    token: that slot's cache and logits go wrong, the others' do not."""
    tokens = tokens.clone()
    tokens[-1] = (tokens[-1] + 1) % vocab
    return tokens


def check_serve(ctx, seeds, faults) -> None:
    server = serve.Server(ctx._replace(seed=seeds[0]))
    for seed in seeds:
        c = ctx._replace(seed=seed)
        program.load_weights(server.model, ctx.config, seed)
        t0 = time.perf_counter()
        emit(seed=seed, kind="sound", **serve_seed(server, c),
             s=time.perf_counter() - t0)
        if seed in faults:
            for f in ("token", "stale", "slot"):
                emit(seed=seed, kind=f"fault.{f}",
                     **serve_seed(server, c, f))


def _half_loss(orig):
    def loss(self, batch, remat=True):
        s = batch["tokens"].shape[1] // 2
        half = {k: (v[..., :s] if k == "positions" else v[:, :s])
                for k, v in batch.items()}
        return orig(self, half, remat=remat)
    return loss


def check_train(ctx, seeds, faults) -> None:
    from repro_torch.models.transformer import LM
    for seed in seeds:
        c = ctx._replace(seed=seed)
        t0 = time.perf_counter()
        model, state, step, prog = train.setup(c)
        del model, state, step
        _free()
        ref = check.reference_train(c)
        _free()
        low = check.reference_train(c, tf32=True)
        _free()
        emit(seed=seed, kind="sound", **check.compare_train(prog, ref),
             losses=prog["losses"], ref_losses=ref["losses"],
             s=time.perf_counter() - t0)
        emit(seed=seed, kind="control", **check.compare_train(low, ref))
        if seed in faults:
            orig = LM.loss
            LM.loss = _half_loss(orig)
            try:
                model, state, step, half = train.setup(c)
                del model, state, step
            finally:
                LM.loss = orig
            _free()
            emit(seed=seed, kind="fault.half", **check.compare_train(half,
                                                                      ref))


def sweep(ctx, rates, backlog, drain) -> None:
    server = serve.Server(ctx)
    mix = ctx.mix
    for b in mix["warmup_batches"]:
        server.serve(traffic.warmup_requests(mix, ctx.config["vocab_size"],
                                             ctx.seed, b))
    for rate in rates:
        m = dict(mix, arrival=dict(mix["arrival"], rate_per_s=rate,
                                   backlog=backlog, drain=drain))
        server.mix = m
        reqs = traffic.serve_requests(m, ctx.config["vocab_size"], ctx.seed,
                                      ctx.seconds, tag=f"sweep{rate}")
        win = serve.window(server, reqs, ctx.seconds)
        rounds = win["rounds"]
        done = sum(len(r.reqs) for r in rounds)
        end = rounds[-1].t_end - win["t0"] if rounds else ctx.seconds
        ttft = sorted(r.t_first - (win["t0"] + q.arrival)
                      for r in rounds for q in r.reqs)
        emit(rate=rate, offered=len(reqs), served=done,
             served_per_s=done / end, span_s=end,
             batches=[len(r.reqs) for r in rounds],
             batch_s=[round(r.t_end - r.t_start, 4) for r in rounds],
             ttft_p50=ttft[len(ttft) // 2] if ttft else None,
             ttft_p95=ttft[int(0.95 * (len(ttft) - 1))] if ttft else None)
    server.mix = mix


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("check", "sweep"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", default="")
    ap.add_argument("--backlog", type=int, default=0)
    ap.add_argument("--drain", type=int, default=1)
    a = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = cell.load(a.workload)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    faults = {int(s) for s in a.faults.split(",") if s}
    ctx = cell.Ctx(spec, seeds[0], a.seconds, False, torch.device("cuda", 0),
                   time.perf_counter())
    if a.what == "sweep":
        sweep(ctx._replace(seed=a.seed),
              [float(r) for r in a.rates.split(",")], a.backlog,
              bool(a.drain))
    elif spec.mix["kind"] == "serve":
        check_serve(ctx, seeds, faults)
    else:
        check_train(ctx, seeds, faults)
    return 0


if __name__ == "__main__":
    sys.exit(main())
