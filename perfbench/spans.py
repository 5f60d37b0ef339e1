#!/usr/bin/env python3
"""The program's own spans in a cell's traced batches or steps, and what
turning them on costs, on the card; the benchmark's runs never run this.

    python3 perfbench/spans.py --workload <cell> --seed <n> \
        [--seconds <s>] [--turns <k>] [--pairs <k>]

Builds and warms the cell as ``run.py`` does.  Then ``--turns`` windows
of ``--seconds`` each, the program's tracing off and on over the whole
window in turns (off, on, on, off, off, on, ...), each read by the
cell's end-to-end metric; then ``--pairs`` pairs of full batches (steps)
of the mix back to back, one of each pair traced, in turns, each timed
on the host to its end.  Then ``TRACED`` more batches (steps) of the
mix, as a ``--trace 1`` run profiles them after its window (the
benchmark's synchronised wrappers on), with the program's tracing on
(``obs.enable(clock=time.time_ns)``, the clock of the profiler's events)
over them alone.  One JSON object a window goes to standard output, and
last one of the traced batches: the device's busy and window seconds,
the idle seconds by the innermost span covering each gap, program or
benchmark (a wrapper of the benchmark whose name the program also uses
is prefixed ``bench:``), the program spans' host self ms, their counts,
and the readings of ``pbcore/spans.py``.
"""
import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import torch  # noqa: E402

from pbcore import cell, serve, spans, traffic, train  # noqa: E402
from pbcore.trace import DeviceTrace, Spans, syncer, top  # noqa: E402

TRACED = 2


class WarmTrace(DeviceTrace):
    """``DeviceTrace`` with the marker kernel launched once before the
    profiler starts.  A process's first launch of ``torch.cuda._sleep``
    starts late (about 0.5 ms on an H100, against 0.06-0.1 ms for a later
    one), and ``DeviceTrace`` takes the marker's delay for the clocks'
    offset, so every host span would land that much late against the
    kernels."""

    def start(self) -> None:
        if self.device.type == "cuda":
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        super().start()

    def marker_us(self):
        """The marker's start less the host's anchor, in µs."""
        if self.prof is None:
            return None
        marks = [s for n, s, _ in self._events() if "spin" in n.lower()]
        return (marks[0] - self.anchor_ns) / 1e3 if marks else None


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def tracing(on: bool) -> None:
    from repro_torch import obs
    obs.disable()
    if on:
        obs.enable(clock=time.time_ns, metrics=False)


def program_spans() -> list:
    from repro_torch import obs
    got = spans.collect(obs.tracer())
    obs.disable()
    return got


def breakdown(dt: WarmTrace, bench: list, prog: list, **extra) -> None:
    """The traced batches' summary, the benchmark's intervals renamed
    where the program uses their names."""
    names = {s["name"] for s in prog}
    ivs = [(f"bench:{n}" if n in names else n, a, b) for n, a, b in bench]
    summary = dt.summary(ivs + spans.intervals(prog))
    out = dict(extra, spans=dict(Counter(s["name"] for s in prog)),
               self_ms=spans.self_ms(prog), readings=spans.readings(prog))
    if summary is not None:
        out.update(marker_us=dt.marker_us(),
                   busy_s=summary["busy_s"], window_s=summary["window_s"],
                   idle=top(summary["idle"], 30),
                   device_ops=top(summary["by_name"]))
    emit(**out)


def paired(run, pairs: int) -> None:
    """``pairs`` pairs of ``run()`` (one batch or step, ending in a
    synchronise), the program's tracing on for one of each, in turns."""
    off, on = [], []
    for i in range(pairs):
        for traced in ((False, True) if i % 2 == 0 else (True, False)):
            tracing(traced)
            t0 = time.perf_counter()
            run()
            (on if traced else off).append(time.perf_counter() - t0)
            program_spans()
    ratio = sorted(b / a for a, b in zip(off, on))
    emit(pairs=pairs, off_s=off, on_s=on,
         on_over_off_median=ratio[len(ratio) // 2])


def serve_cell(ctx, turns: int, pairs: int = 0) -> None:
    server = serve.Server(ctx._replace(trace=False))
    mix, vocab = ctx.mix, ctx.config["vocab_size"]
    for b in mix["warmup_batches"]:
        server.serve(traffic.warmup_requests(mix, vocab, ctx.seed, b))
    server.sync()
    e2e = [m["name"] for m in ctx.cell.end_to_end if m["name"] != "setup_s"]
    sizes = []
    for k in range(turns):
        on = k % 4 in (1, 2)
        reqs = traffic.serve_requests(mix, vocab, ctx.seed, ctx.seconds,
                                      tag=f"turn{k}")
        tracing(on)
        win = serve.window(server, reqs, ctx.seconds)
        n = len(program_spans())
        rec = serve.record(ctx, win, {}, (0, 0), None, 0.0, 0)
        sizes += [len(r.reqs) for r in win["rounds"]]
        emit(window=k, tracing=on, program_spans=n,
             batches=len(win["rounds"]),
             **{m: cell.reader(m, ctx.cell.root)(rec) for m in e2e})
    b = sorted(sizes)[len(sizes) // 2] if sizes else mix["max_batch"]
    if pairs:
        full = mix["max_batch"]
        per_s = mix["arrival"]["rate_per_s"]
        queue = iter(traffic.serve_requests(
            mix, vocab, ctx.seed, 2 * pairs * full / per_s + 10,
            tag="pairs"))
        paired(lambda: server.serve([next(queue) for _ in range(full)],
                                    keep=False), pairs)
    pool, model = server.engine.pool, server.model
    server.spans.wrap(pool, "lookup_batch", "pool.lookup")
    server.spans.wrap(pool, "write_page", "pool.write")
    server.spans.wrap(model, "prefill", "prefill")
    server.spans.wrap(model, "decode_step", "decode_step")
    reqs = traffic.serve_requests(mix, vocab, ctx.seed, 60.0, tag="traced")
    dt = WarmTrace(ctx.device)
    server.spans.keep = True
    tracing(True)
    dt.start()
    rounds = [server.serve(reqs[k * b:(k + 1) * b], keep=False)
              for k in range(TRACED)]
    dt.stop()
    prog = program_spans()
    breakdown(dt, server.spans.intervals, prog,
              rounds=[(len(r.reqs), r.steps) for r in rounds])
    server.close()


def train_cell(ctx, turns: int, pairs: int = 0) -> None:
    mix, vocab, dev = ctx.mix, ctx.config["vocab_size"], ctx.device
    model, state, step, _ = train.setup(ctx)
    sync = syncer(dev)
    k = 1000
    for w in range(turns):
        on = w % 4 in (1, 2)
        tracing(on)
        sync()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() < t0 + ctx.seconds:
            state, m = step(state, traffic.train_batch(mix, vocab, ctx.seed,
                                                       k, dev))
            k, n = k + 1, n + 1
        sync()
        el = time.perf_counter() - t0
        emit(window=w, tracing=on, program_spans=len(program_spans()),
             steps=n, train_tokens_per_s=n * mix["batch"] * mix["seq"] / el)
    if pairs:
        def one():
            nonlocal state, k
            state, _ = step(state, traffic.train_batch(mix, vocab, ctx.seed,
                                                       k, dev))
            k += 1
            sync()
        paired(one, pairs)
    bench = Spans(dev)
    bench.wrap(model, "loss", "train.forward", sync=False)
    bench.keep = True
    dt = WarmTrace(dev)
    tracing(True)
    dt.start()
    for _ in range(TRACED):
        w0 = time.time_ns()
        state, m = step(state, traffic.train_batch(mix, vocab, ctx.seed, k,
                                                   dev))
        k += 1
        bench.mark("train.step", w0, time.time_ns())
    dt.stop()
    prog = program_spans()
    bench.unwrap()
    breakdown(dt, bench.intervals, prog, steps=TRACED)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--pairs", type=int, default=0)
    a = ap.parse_args()
    spec = cell.load(a.workload)
    if not torch.cuda.is_available():
        print("no result: needs a CUDA card", file=sys.stderr)
        return 3
    tf32 = bool(spec.config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    ctx = cell.Ctx(spec, a.seed, a.seconds, True, torch.device("cuda", 0),
                   time.perf_counter())
    if spec.mix["kind"] == "serve":
        serve_cell(ctx, a.turns, a.pairs)
    else:
        train_cell(ctx, a.turns, a.pairs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
