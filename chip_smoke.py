#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the Morpheus simulator on one NVIDIA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero and prints no result):

  1. device and build: the card's name and power limit, then ``nvcc`` of
     the kernels from ``src/repro_torch/kernels/csrc`` with its ``-Xptxas
     -v`` report (registers, shared memory, spills);
  2. kernel vs plain: batches of 16 ``cfd`` traces of 120 000 requests
     under predictor {BLOOM, NONE, PERFECT} x compression {off, on} and a
     conventional-only config (BL); each CUDA kernel against its plain
     PyTorch version on the same tensors (integer Stats and state rows
     identical, float sums within 1e-3 relative), and a 4-epoch
     ``advance_packed`` partition identical to one run;
  3. golden: integer Stats of three full-width cells against the JAX
     reference's values in ``tests/data/torch_golden_stats.json``;
  4. main path: ``policy.table3`` for IBL / Morpheus-Basic / Morpheus-ALL
     x cfd / kmeans / spmv at 120 000 requests through the kernels, with
     the launch counts of that run, its best splits against the
     reference's (same file), points/s, and host (trace generation +
     ``pack``) against device (scan kernels, CUDA events) time;
  5. the ported kernels with their launches, errors, times and bounds.

The last lines are the card (``nvidia-smi``), the ``{"kernels": ...}``
record, and ``{"ok": true, "device": ...}``.  Needs one CUDA card, the
CUDA toolkit and this checkout; imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "data" / "torch_golden_stats.json"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (guide table)
PEAK_OPS_PER_S = 67e12           # H100 SXM float32 outside tensor cores
LENGTH = 120_000
BATCH = 16
FLOAT_RTOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Env:
    """The port's modules, imported after the checks that they exist."""

    def __init__(self):
        sys.path.insert(0, str(SRC))
        from repro_torch.core import cache_sim, controller, engine, policy
        from repro_torch.kernels import _build, engine_scan
        self.cs, self.ctl, self.engine = cache_sim, controller, engine
        self.policy, self.build, self.scan = policy, _build, engine_scan


def timed_cuda(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls,
    after one warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(kernel, plain, ctx: str) -> float:
    """Kernel outputs vs plain outputs: integer Stats and state rows
    identical, floats within FLOAT_RTOL; returns the max abs float error."""
    ki, kf, krows = kernel
    pi, pf, prows = plain
    if not torch.equal(ki, pi):
        bad = (ki != pi).nonzero()[:5].tolist()
        fail(f"{ctx}: integer Stats differ at {bad}")
    err = (kf - pf).abs()
    if not bool((err <= FLOAT_RTOL * pf.abs().clamp_min(1.0)).all()):
        fail(f"{ctx}: float Stats differ by up to {float(err.max())}")
    if prows is not None:
        for name, k, p in zip(prows._fields, krows, prows):
            if not torch.equal(k, p):
                fail(f"{ctx}: state row {name} differs")
    return float(err.max()) if err.numel() else 0.0


def bound_ms(tier: str, pt, b_s: int, ways: int) -> tuple:
    """Least time for one dispatch: bytes (each input read once, each
    output written once) over the memory rate, against lane operations
    (about 4 per way and request, plus 3 hashes on the extended tier) of
    this run's active requests over the float32 peak; the larger wins."""
    if tier == "conv":
        cols = (pt.conv_tag, pt.conv_write, pt.conv_active)
        active = int(pt.conv_active.sum())
        per_req = 4 * ways
    else:
        cols = (pt.ext_tag, pt.ext_write, pt.ext_level, pt.ext_active)
        active = int(pt.ext_active.sum())
        per_req = 4 * ways + 3 * 10
    slots = cols[0].numel()
    in_bytes = sum(c.element_size() * c.numel() for c in cols) + slots
    out_bytes = b_s * (9 + 5) * 4     # (+ slots above: the 1-byte mask)
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = active * per_req / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(env: Env, dev) -> dict:
    """Phase 2: each kernel vs its plain version at full width."""
    cs, ctl, engine, scan = env.cs, env.ctl, env.engine, env.scan
    base = cs.RunPoint("cfd", "Morpheus-Basic", 32, 36, LENGTH)
    traces = [cs._prepare(cs.RunPoint(base.app, base.system, base.n_compute,
                                      base.n_cache, LENGTH, seed))[1]
              for seed in range(BATCH)]
    configs = [(p, c) for p in ctl.Predictor for c in (False, True)]
    cfgs = [(f"{p.value}/comp={int(c)}",
             cs.apply_overrides(cs.build_config(cs.SYSTEMS["Morpheus-Basic"],
                                                36),
                                (("compression", c), ("predictor", p))))
            for p, c in configs]
    cfgs.append(("BL", cs.build_config(cs.SYSTEMS["BL"], 0)))
    err = {"conv_scan": 0.0, "ext_scan": 0.0}
    timing = {}
    for name, cfg in cfgs:
        pt = engine.to_device(engine.pack(cfg, traces), dev)
        warm = pt.warmup[:, None, None]
        cmask = pt.conv_active & (pt.conv_pos >= warm)
        conv_args = (cfg, pt.conv_tag, pt.conv_write, pt.conv_active, cmask)
        k = scan.conv_scan(*conv_args, keep_state=True)
        p = scan.conv_scan_plain(*conv_args, keep_state=True)
        err["conv_scan"] = max(err["conv_scan"],
                               compare(k, p, f"conv_scan {name}"))
        ext_args = None
        if cfg.ext_enabled:
            emask = pt.ext_active & (pt.ext_pos >= warm)
            ext_args = (cfg, pt.ext_tag, pt.ext_write, pt.ext_level,
                        pt.ext_active, emask)
            k = scan.ext_scan(*ext_args, keep_state=True)
            p = scan.ext_scan_plain(*ext_args, keep_state=True)
            err["ext_scan"] = max(err["ext_scan"],
                                  compare(k, p, f"ext_scan {name}"))
        if name == "bloom/comp=1":     # the Morpheus-ALL shape of the path
            b_s_c = pt.conv_tag.shape[0] * pt.conv_tag.shape[1]
            b_s_e = pt.ext_tag.shape[0] * pt.ext_tag.shape[1]
            timing["conv_scan"] = dict(
                ms=timed_cuda(lambda: scan.conv_scan(*conv_args), 20),
                plain_ms=timed_cuda(lambda: scan.conv_scan_plain(*conv_args),
                                    2),
                bound=bound_ms("conv", pt, b_s_c, cfg.conv_ways),
                shape=list(pt.conv_tag.shape))
            timing["ext_scan"] = dict(
                ms=timed_cuda(lambda: scan.ext_scan(*ext_args), 20),
                plain_ms=timed_cuda(lambda: scan.ext_scan_plain(*ext_args),
                                    2),
                bound=bound_ms("ext", pt, b_s_e, cfg.ext_max_ways),
                shape=list(pt.ext_tag.shape))
            epoch_check(env, cfg, traces, dev)
        log(f"phase 2: {name}: kernels == plain (L conv "
            f"{pt.conv_tag.shape[2]}, ext {pt.ext_tag.shape[2]})")
    return {"err": err, "timing": timing}


def epoch_check(env: Env, cfg, traces, dev) -> None:
    """A 4-epoch advance_packed partition equals one monolithic run."""
    engine = env.engine
    mono = engine.simulate_batch(cfg, traces, dev)
    state = engine.init_state(cfg, len(traces), dev)
    cuts = [0, 20_000, 55_000, 90_000, LENGTH]
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        sl = [(a[lo:hi], w[lo:hi], l[lo:hi], wm) for a, w, l, wm in traces]
        pt = engine.pack(cfg, sl, pos0=[lo] * len(traces))
        state, _ = engine.advance_packed(cfg, pt, state, dev)
    for f in env.ctl._INT_FIELDS:
        if not torch.equal(getattr(mono, f), getattr(state.stats, f)):
            fail(f"epoch partition: {f} differs from one run")
    if int(state.pos.min()) != LENGTH:
        fail("epoch partition: position does not reach the trace end")
    log("phase 2: 4-epoch advance_packed partition == one run")


def phase_golden(env: Env, dev) -> None:
    cells = json.loads(GOLDEN.read_text())["cells"]
    pts = [env.cs.RunPoint(c["app"], c["system"], c["n_compute"],
                           c["n_cache"], c["length"], c["seed"])
           for c in cells]
    for c, r in zip(cells, env.cs.run_batch(pts, dev)):
        got = {f: int(getattr(r.stats, f)) for f in c["stats"]}
        if got != c["stats"]:
            fail(f"golden {c['app']}/{c['system']}: {got} != {c['stats']}")
    log(f"phase 3: golden integer Stats of {len(cells)} cells match the "
        f"reference's")


def host_device_split(env: Env, points, dev) -> dict:
    """Re-run the sweep's dispatches step by step: host seconds of trace
    generation and pack, device milliseconds of the scan kernels."""
    cs, engine = env.cs, env.engine
    t0 = time.perf_counter()
    prepped = [cs._prepare(p) for p in points]
    gen_s = time.perf_counter() - t0
    groups = {}
    for i, (cfg, *_rest) in enumerate(prepped):
        groups.setdefault(cfg, []).append(i)
    pack_s = copy_ms = scan_ms = 0.0
    dispatches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for cfg, idxs in groups.items():
        done = 0
        for blen in cs._chunk_lengths(len(idxs)):
            chunk = idxs[done:done + blen]
            done += len(chunk)
            traces = [prepped[i][1] for i in chunk]
            traces += [traces[-1]] * (blen - len(traces))
            t0 = time.perf_counter()
            pt = engine.pack(cfg, traces)
            pack_s += time.perf_counter() - t0
            ev[0].record()
            tp = engine.to_device(pt, dev)
            ev[1].record()
            engine._run_packed(cfg, tp)
            ev[2].record()
            torch.cuda.synchronize()
            copy_ms += ev[0].elapsed_time(ev[1])
            scan_ms += ev[1].elapsed_time(ev[2])
            dispatches += 1
    return dict(gen_s=gen_s, pack_s=pack_s, copy_ms=copy_ms,
                scan_ms=scan_ms, dispatches=dispatches)


def phase_main(env: Env, dev) -> dict:
    """Phase 4: the Table-3 sweep through the kernels, with launch counts."""
    policy, scan = env.policy, env.scan
    ref = json.loads(GOLDEN.read_text())["table3"]
    systems, apps, length = ref["systems"], ref["apps"], ref["length"]
    points = [p for s in systems for a in apps
              for p in policy.grid_points(a, s, grid=policy.DEFAULT_GRID,
                                          length=length)]
    scan.reset_launches()
    t0 = time.perf_counter()
    table = policy.table3(systems, apps, length=length, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(scan.launches)
    plain = dict(scan.plain_runs)
    for name, n in counts.items():
        if n <= 0:
            fail(f"main path: kernel {name} was not launched")
        if plain[name]:
            fail(f"main path: plain {name} ran {plain[name]} times")
    splits = {s: {a: [m.n_compute, m.n_cache] for a, m in row.items()}
              for s, row in table.items()}
    for s, row in table.items():
        for a, m in row.items():
            if not (math.isfinite(m.exec_time_s) and m.exec_time_s > 0):
                fail(f"main path: {s}/{a} exec time {m.exec_time_s}")
    if splits != ref["best_splits"]:
        fail(f"main path: best splits {splits} != the reference's "
             f"{ref['best_splits']}")
    small_check(env, dev)
    split = host_device_split(env, points, dev)
    log(f"phase 4: table3 {len(points)} points in {wall:.3f} s "
        f"({len(points) / wall:.2f} points/s); best splits "
        f"{json.dumps(splits)}; launches {json.dumps(counts)}, plain "
        f"runs {json.dumps(plain)}; host "
        f"generate {split['gen_s']:.3f} s + pack {split['pack_s']:.3f} s, "
        f"device copy {split['copy_ms']:.2f} ms + scan "
        f"{split['scan_ms']:.2f} ms over {split['dispatches']} dispatches")
    return {"launches": counts, "points": len(points), "wall_s": wall,
            "split": split}


def small_check(env: Env, dev) -> None:
    """The card's sweep agrees with the plain version on a small input."""
    kw = dict(grid=(24, 40), length=6000)
    for app, system in (("kmeans", "Morpheus-ALL"), ("cfd", "IBL")):
        g = env.policy.best_split(app, system, device=dev, **kw)
        c = env.policy.best_split(app, system, device="cpu", **kw)
        if (g.n_compute, g.n_cache) != (c.n_compute, c.n_cache) or \
                abs(g.exec_time_s - c.exec_time_s) > \
                FLOAT_RTOL * c.exec_time_s:
            fail(f"best_split {app}/{system}: card {g} != cpu {c}")


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    card = card_line()
    log(f"phase 1: card {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    env = Env()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    env.build.build("engine_scan")
    report = [ln.strip() for ln in env.build.build_log("engine_scan")
              .splitlines() if "registers" in ln or "spill" in ln
              or "Compiling entry" in ln]
    log(f"phase 1: built engine_scan in {time.perf_counter() - t0:.1f} s; "
        f"ptxas: {' | '.join(report)}")

    k = phase_kernels(env, dev)
    phase_golden(env, dev)
    main_path = phase_main(env, dev)

    if any(m in sys.modules for m in ("jax", "repro")):
        fail("the port imported jax or repro")
    source = "src/repro_torch/kernels/csrc/engine_scan.cu"
    replaces = {"conv_scan": ("src/repro/kernels/engine_scan.py:97",
                              "src/repro/kernels/engine_scan.py:248"),
                "ext_scan": ("src/repro/kernels/engine_scan.py:135",
                             "src/repro/kernels/engine_scan.py:283")}
    kernels = []
    for name in ("conv_scan", "ext_scan"):
        t = k["timing"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces[name][0],
            "also_replaces": replaces[name][1],
            "launches": main_path["launches"][name],
            "max_abs_err": k["err"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": None, "shape_BSL": t["shape"],
        })
    log("phase 5: kernels " + ", ".join(
        f"{x['name']} matched plain (max abs err {x['max_abs_err']:.3g}), "
        f"{x['ms']:.3f} ms vs plain {x['plain_ms']:.1f} ms, bound "
        f"{x['bound_ms']:.4f} ms ({x['bound_by']})" for x in kernels))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
