"""A serving cell: the program's ``Engine`` (its Morpheus page pool on,
as built by default) serving a mix's requests as they arrive.

The server is the benchmark's loop around ``Engine.run``, which serves
one batch of equal-length prompts to completion: whenever it is free it
takes the requests queued so far, oldest first, up to the mix's
``max_batch``, and waits for the next arrival when none is queued.  The
load is open-loop at the mix's fixed rate, so a slower program meets a
longer queue.  A mix with ``drain`` (a cell below the program's
capacity) serves every request that arrives in the window, up to
``DRAIN_S`` past its close, and is measured by the time to first token
(submission to the first token on the host) of all of them.  A mix
without ``drain`` (above capacity, its queue growing) starts batches
until the window closes, and is measured by the tokens of those batches
over the time from the window's opening to the last one's end.

``--trace 1`` times every call into the layers (the pool's lookups and
writes, the prefill, each decode step: ``trace.Spans``) through the
window, and afterwards profiles ``TRACED_BATCHES`` more batches of the
mix's traffic for the device's share (``trace.DeviceTrace``), so that
the profiler's cost falls outside the window.
"""
from __future__ import annotations

import gc
import time
from collections import deque
from typing import List, Optional

import torch

from . import check, program, traffic
from .trace import DeviceTrace, Spans, syncer

DRAIN_S = 60.0
TRACED_BATCHES = 2


class Round:
    """One batch: its requests, when it started, when its first tokens
    reached the host, when it ended, what it served and the logits
    (B, new, V) it served from."""

    def __init__(self, reqs, t_start):
        self.reqs = reqs
        self.t_start = t_start
        self.t_first = self.t_end = 0.0
        self.out: List[List[int]] = []
        self.logits: Optional[torch.Tensor] = None
        self.steps = 0


class Server:
    def __init__(self, ctx):
        from repro_torch.serving.engine import Engine, Request
        self.ctx, self.Request = ctx, Request
        self.cfg, self.mix = ctx.config, ctx.mix
        self.sync = syncer(ctx.device)
        self.model = program.build_model(self.cfg, ctx.seed, ctx.device)
        self.engine = Engine(self.model, max_len=self.mix["prompt_tokens"]
                             + self.mix["new_tokens"])
        self.spans = Spans(ctx.device)
        self._first = 0.0
        self._keep = True
        self._logits: List[torch.Tensor] = []
        prefill, decode_step = self.model.prefill, self.model.decode_step

        def first_token(*a, **k):        # the first tokens of a batch
            out = prefill(*a, **k)
            self.sync()
            self._first = time.perf_counter()
            self._logits = [out[0].clone()] if self._keep else []
            return out

        def next_token(*a, **k):
            out = decode_step(*a, **k)
            if self._keep:
                self._logits.append(out[0].clone())
            return out
        self.model.prefill = first_token
        self.model.decode_step = next_token
        if ctx.trace:
            pool = self.engine.pool
            self.spans.wrap(pool, "lookup_batch", "pool.lookup")
            self.spans.wrap(pool, "write_page", "pool.write")
            self.spans.wrap(self.model, "prefill", "prefill")
            self.spans.wrap(self.model, "decode_step", "decode_step")

    def serve(self, reqs, keep: bool = True) -> Round:
        """One batch of ``reqs``; with ``keep`` the logits it served from
        are kept on the round."""
        rnd = Round(reqs, time.perf_counter())
        self._keep = keep
        w0 = time.time_ns()
        batch = [self.Request(r.rid, r.prompt.tolist(),
                              self.mix["new_tokens"]) for r in reqs]
        rep = self.engine.run(batch)
        self.sync()
        rnd.t_end = time.perf_counter()
        self.spans.mark("batch", w0, time.time_ns())
        rnd.t_first, rnd.steps = self._first, rep.steps
        rnd.out = [list(b.out_tokens) for b in batch]
        rnd.logits = torch.stack(self._logits, 1) if keep else None
        self._logits = []
        return rnd

    def close(self) -> None:
        self.spans.unwrap()
        del self.engine, self.model
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def window(server: Server, reqs, seconds: float) -> dict:
    """Serve ``reqs`` (arrival offsets from the window's opening) as the
    mix's loop says; returns the rounds, the requests left unserved and
    the opening time.  Only the batches of the seed's ``check.Sample``
    keep their logits."""
    mix = server.mix
    sample = check.Sample(server.ctx.seed, mix["check_tokens"])
    bmax, drain = mix["max_batch"], mix["arrival"]["drain"]
    pending, i, rounds = deque(), 0, []
    t0 = time.perf_counter()
    close, give_up = t0 + seconds, t0 + seconds + DRAIN_S
    while True:
        now = time.perf_counter()
        while i < len(reqs) and t0 + reqs[i].arrival <= now:
            pending.append(reqs[i])
            i += 1
        if now >= close and (not drain or now >= give_up
                             or (not pending and i == len(reqs))):
            break
        if not pending:
            nxt = t0 + reqs[i].arrival if i < len(reqs) else close
            time.sleep(max(0.0, min(nxt, close) - now) or 1e-4)
            continue
        take = [pending.popleft() for _ in range(min(bmax, len(pending)))]
        k, keep = len(rounds), sample.wants(len(rounds))
        rounds.append(server.serve(take, keep))
        if keep:
            sample.offer(k, rounds[-1])
    return {"t0": t0, "rounds": rounds,
            "unserved": list(pending) + list(reqs[i:]) if drain else [],
            "t_stop": time.perf_counter()}


def run(ctx) -> dict:
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    vocab = cfg["vocab_size"]
    server = Server(ctx)
    for b in mix["warmup_batches"]:
        server.serve(traffic.warmup_requests(mix, vocab, ctx.seed, b))
    server.sync()
    setup_s = time.perf_counter() - ctx.t_start
    eng = server.engine
    reused0, fetched0 = eng.pages_reused, eng.pages_fetched
    server.spans.reset()
    reqs = traffic.serve_requests(mix, vocab, ctx.seed, ctx.seconds)
    win = window(server, reqs, ctx.seconds)
    calls = {k: (v, server.spans.calls[k])
             for k, v in server.spans.total.items()}
    pages = (eng.pages_reused - reused0, eng.pages_fetched - fetched0)
    summary = None
    if ctx.trace:
        summary = traced(server, win["rounds"])
    peak = (torch.cuda.max_memory_allocated()
            if dev.type == "cuda" else 0)
    server.close()
    rec = record(ctx, win, calls, pages, summary, setup_s, peak)
    rec["checks"] = check.served(ctx, win["rounds"])
    return rec


def traced(server: Server, rounds: List[Round]) -> Optional[dict]:
    """Profile ``TRACED_BATCHES`` batches of the mix after the window, of
    the window's median batch size."""
    ctx, mix = server.ctx, server.mix
    sizes = sorted(len(r.reqs) for r in rounds) or [mix["max_batch"]]
    b = sizes[len(sizes) // 2]
    reqs = traffic.serve_requests(mix, ctx.config["vocab_size"], ctx.seed,
                                  60.0, tag="traced")
    dt = DeviceTrace(ctx.device)
    server.spans.keep = True
    server.spans.intervals.clear()
    dt.start()
    traced_rounds = [server.serve(reqs[k * b:(k + 1) * b], keep=False)
                     for k in range(TRACED_BATCHES)]
    dt.stop()
    server.spans.keep = False
    summary = dt.summary(server.spans.intervals)
    if summary is not None:
        summary["rounds"] = [(len(r.reqs), r.steps) for r in traced_rounds]
    return summary


def record(ctx, win, calls, pages, summary, setup_s, peak) -> dict:
    """What the metric readers read: the rounds, the requests' times to
    first token, the spans, the pool's pages, the device trace."""
    mix = ctx.mix
    t0, rounds = win["t0"], win["rounds"]
    ttft, waits = [], []
    for r in rounds:
        for q in r.reqs:
            ttft.append(r.t_first - (t0 + q.arrival))
            waits.append(r.t_start - (t0 + q.arrival))
    give_up = t0 + ctx.seconds + DRAIN_S
    ttft += [give_up - (t0 + q.arrival) for q in win["unserved"]]
    tokens = sum(len(o) for r in rounds for o in r.out)
    end = rounds[-1].t_end if rounds else win["t_stop"]
    return {
        "kind": "serve", "config": ctx.config, "mix": mix,
        "setup_s": setup_s, "memory_peak_bytes": int(peak),
        "attempted": len(ttft), "failed": len(win["unserved"]),
        "ttft_s": ttft, "queue_wait_s": waits,
        "tokens": tokens, "elapsed_s": end - t0,
        "round_shapes": [(len(r.reqs), r.steps, r.t_end - r.t_start)
                         for r in rounds],
        "spans": calls, "pages": pages, "trace": summary,
    }
