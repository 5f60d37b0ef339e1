#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the Morpheus simulator, its serving
page pool and its serving engine on one NVIDIA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero and prints no result):

  1. device and build: the card's name and power limit, the float32
     matmul settings (TF32 off, precision "highest"), then ``nvcc`` of
     the kernel sources of ``src/repro_torch/kernels/csrc`` (one process
     each, all started together) with their ``-Xptxas -v`` reports
     (registers, shared memory, spills), summed up per kernel for the
     engine-scan and attention kernels;
  2. kernel vs plain: batches of 16 ``cfd`` traces of 120 000 requests
     under predictor {BLOOM, NONE, PERFECT} x compression {off, on} and a
     conventional-only config (BL); each engine-scan kernel against its
     plain PyTorch version on the same tensors (integer Stats and state
     rows identical, float sums within 1e-3 relative), and a 4-epoch
     ``advance_packed`` partition identical to one run; state rows
     outside the kernels' row contract (lru above 0xFFF, an extended size
     of 48 bytes, a tag valid in two ways) raise ``ValueError``; at the
     path's shape each kernel's time, its launch (blocks, blocks resident
     on an SM, waves), the longest set's active slots and ns a request
     slot, beside the times before the Hopper redesign, quoted from
     PERF.md;
  3. golden: integer Stats of three full-width cells against the JAX
     reference's values in ``tests/data/torch_golden_stats.json``;
  4. main path of the simulator: ``policy.table3`` for IBL /
     Morpheus-Basic / Morpheus-ALL x cfd / kmeans / spmv at 120 000
     requests through the kernels, with the launch counts of that run,
     its best splits against the reference's (same file), points/s, and
     host (trace generation + ``pack``) against device time (each
     dispatch by CUDA events, and the scan kernels' own device time from
     a profiled pass);
  5. pool kernels vs plain at large shapes: ``tag_lookup`` on (51200, 8)
     and (51200, 32), ``lookup_fill`` of 512 requests (4 rounds) on
     (51200, 8), ``bloom_query`` on 4096 queries (pre-gathered, and by row
     of a (51200, 8) store), ``bloom_record`` of 4096 keys over 51 200
     sets with repeats, ``bdi_compress`` of 65 536 blocks of every level
     and the decompress round trip, ``page_write`` of 4096 pages into
     phase 8's (51200, 32) extended store with BDI, the block read (plain
     and fused with decompression) of 4096 rows of (4096, 32, 32), and
     ``read_rows`` of 4096 rows of both tiers from phase 8's stores, each
     equal to its plain version (tolerance 0; the in-place wrappers on
     copies of their state), with times and bounds, and the floor of a
     launch (a one-element ``add_``);
  6. golden pool: the serving pool on the card replays the three cells
     of ``tests/data/torch_golden_pool.json``; stats and crcs of plans,
     pages read and final state equal the reference's;
  7. main path of the pool, engine traffic: the reference serving
     engine's own pool (64 conventional sets and 4 x 32 extended sets of
     4 ways) consulted as ``Engine.run`` does, one page key
     ``page_key(prefix hash, 0, page)`` a call, for 900 chat prompts that
     share Zipf-popular system prompts and continue earlier
     conversations; a fetch installs the prefix's blake2b digest, every
     hit must read back what was installed; the working set exceeds the
     pool, so pages are evicted; launches by wrapper (one ``lookup_fill``
     a conventional lookup, one predictor query and one Bloom record an
     extended lookup, one ``page_write`` a ``write_page``, one block read
     a hit, no ``tag_lookup`` or ``bdi_compress``, or the phase fails),
     keys per second, hit rate, evictions, and a profiled window of host
     against device time;
  8. full-scale pool: 51 200 conventional sets (50 MiB of 128-byte
     blocks) and 4 x 12 800 extended sets of 4 x 8 BDI slots under a
     batched synthetic mix (128 rounds of 512 keys from 32 sequences x 36
     layers x 16 pages, payloads of every BDI level), with the same
     checks (at most one ``lookup_fill``, two Bloom launches and one block
     read a round); it
     evicts nothing and stands for no user's traffic: it runs the kernels
     at the full store's shapes with the state on the card;
  9. every pool-kernel call of phases 7 and 8, one per input shape,
     replayed against its plain version (tolerance 0; the in-place
     wrappers on copies of their inputs), and the most frequent and the
     largest shape of each timed with its bound;
  10. attention kernels vs plain at large shapes: decode with B = 8,
     H = 32, KV = 8, hd = 128, T = 1088 and flash with B = 8, S = T =
     1024, causal, in f32 and bf16; the bf16 calls gemma3-27b's serving
     would make (flash B = 2, S = T = 4096, H = 32, KV = 16, causal,
     window 1024; decode B = 8, H = 32, KV = 16, T = 4096, whose 268 MB of
     K/V exceed the 50 MB L2); plus the reference test's variants
     (softcap, ragged S, cross-attention with hdv != hd, window), within
     the reference's tolerances, with times, bounds and SDPA's time;
  11. golden LM: the port's LM on the card (qwen3-4b at full width, 2
     layers) replays ``tests/data/torch_golden_lm.json`` teacher-forced;
  12. main path of the serving engine: qwen3-4b at full width and depth
     (36 layers, d_model 2560, float32, weights from a CUDA generator
     with seed 0) served by ``Engine`` with its own pool: 8 prompts of
     1024 tokens and 32 new tokens cold, the same prompts again, and 8
     prompts sharing their first 512 tokens with those; Morpheus off
     must give round 1's tokens; both attention kernels launch 36 times
     per prefill and per decode step, and no plain version runs;
     prefill seconds, decode ms a step, tokens/s, page hits, the decode
     step's bytes bound, and the attention kernels' device share of a
     profiled prefill and decode step;
  13. every attention call of phase 12, one per input shape, replayed
     against its plain version and timed with its bound and SDPA's time;
  14. the ported kernels with their launches (phase 4 for the engine
     scans, phase 7 for the pool, phase 12 for attention), errors, times
     and bounds.

The last lines are the card (``nvidia-smi``), the ``{"kernels": ...}``
record, and ``{"ok": true, "device": ...}``.  Needs one CUDA card, the
CUDA toolkit and this checkout; imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "data" / "torch_golden_stats.json"
GOLDEN_POOL = ROOT / "tests" / "data" / "torch_golden_pool.json"
GOLDEN_LM = ROOT / "tests" / "data" / "torch_golden_lm.json"
SOURCES = ("engine_scan", "pool", "attention")

# The device ms of the engine-scan kernels at phase 2's timed shape before
# their Hopper redesign, quoted from PERF.md (kernel table: NVIDIA H100
# 80GB HBM3 at 700 W), for the log only
SCAN_BEFORE_MS = {"conv_scan": "0.0527", "ext_scan": "1.746-1.761"}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (guide table)
PEAK_OPS_PER_S = 67e12           # H100 SXM float32 outside tensor cores
PEAK_BF16_PER_S = 989e12         # H100 SXM bf16 on the tensor cores, dense
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
        from repro_torch import configs
        from repro_torch import models
        from repro_torch.core import cache_sim, controller, engine, policy
        from repro_torch.kernels import (_build, attention, engine_scan, ops,
                                         pool)
        from repro_torch.serving import engine as serving_engine
        from repro_torch.serving import paged_kv
        self.cs, self.ctl, self.engine = cache_sim, controller, engine
        self.policy, self.build, self.scan = policy, _build, engine_scan
        self.ops, self.pool, self.kv = ops, pool, paged_kv
        self.att, self.configs, self.models = attention, configs, models
        self.serving = serving_engine


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


def profiled(fn) -> tuple:
    """(host wall seconds, {kernel or copy name: device microseconds})
    of ``fn()`` under ``torch.profiler``; the dict is empty when the
    profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    us = {e.key: float(getattr(e, "self_device_time_total", 0.0) or 0.0)
          for e in prof.key_averages()}
    return wall, {k: v for k, v in us.items() if v > 0}


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn()``: ``reps`` calls
    captured in one CUDA graph and replayed between CUDA events, so the
    host's launch time drops out.  ``fn`` must not synchronise."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return timed_cuda(graph.replay, 3) / reps


def times(kernel, plain, reps: int, plain_reps: int, library=None,
          plain_on_graph: bool = True) -> dict:
    """Device ms per call of a kernel's wrapper, its plain version and a
    library call (``device_ms``), and the kernel's ms per call back to
    back (CUDA events: the host's launch time shows where it is the
    longer).  A plain version that synchronises (the engine scans' Python
    loops) is timed back to back instead."""
    return dict(ms=device_ms(kernel, reps), call_ms=timed_cuda(kernel, reps),
                plain_ms=(device_ms if plain_on_graph else timed_cuda)(
                    plain, plain_reps),
                library_ms=device_ms(library, reps) if library else None)


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
        rows = {"conv": k[2]}
        ext_args = None
        if cfg.ext_enabled:
            emask = pt.ext_active & (pt.ext_pos >= warm)
            ext_args = (cfg, pt.ext_tag, pt.ext_write, pt.ext_level,
                        pt.ext_active, emask)
            k = scan.ext_scan(*ext_args, keep_state=True)
            p = scan.ext_scan_plain(*ext_args, keep_state=True)
            err["ext_scan"] = max(err["ext_scan"],
                                  compare(k, p, f"ext_scan {name}"))
            rows["ext"] = k[2]
        if name == "bloom/comp=1":     # the Morpheus-ALL shape of the path
            b_s_c = pt.conv_tag.shape[0] * pt.conv_tag.shape[1]
            b_s_e = pt.ext_tag.shape[0] * pt.ext_tag.shape[1]
            timing["conv_scan"] = dict(
                **times(lambda: scan.conv_scan(*conv_args),
                        lambda: scan.conv_scan_plain(*conv_args), 20, 2,
                        plain_on_graph=False),
                bound=bound_ms("conv", pt, b_s_c, cfg.conv_ways),
                shape=list(pt.conv_tag.shape))
            timing["ext_scan"] = dict(
                **times(lambda: scan.ext_scan(*ext_args),
                        lambda: scan.ext_scan_plain(*ext_args), 20, 2,
                        plain_on_graph=False),
                bound=bound_ms("ext", pt, b_s_e, cfg.ext_max_ways),
                shape=list(pt.ext_tag.shape))
            for tier, ways, act in (("conv", cfg.conv_ways, pt.conv_active),
                                    ("ext", cfg.ext_max_ways, pt.ext_active)):
                t = timing[f"{tier}_scan"]
                longest = int(act.sum(-1).max())
                t.update(launch=scan.launch_shape(
                    tier, ways, act.shape[0] * act.shape[1], dev),
                    ways=ways, longest_active=longest,
                    ns_per_slot=t["ms"] * 1e6 / longest)
            epoch_check(env, cfg, traces, dev)
            contract_check(env, conv_args, ext_args, rows)
        log(f"phase 2: {name}: kernels == plain (L conv "
            f"{pt.conv_tag.shape[2]}, ext {pt.ext_tag.shape[2]})")
    log("phase 2: at the path's shape (bloom/comp=1): " + "; ".join(
        f"{k} {v['shape']}, {v['ways']} ways: {v['ms']:.4f} ms on the card "
        f"({v['call_ms']:.4f} ms a call), bound {v['bound'][0]:.5f} ms "
        f"({v['bound'][1]}); {v['launch']['blocks']} blocks of "
        f"{v['launch']['threads']} threads, "
        f"{v['launch']['resident_blocks_per_sm']} resident a SM on "
        f"{v['launch']['sms']} SMs, {v['launch']['waves']:.3f} waves; "
        f"longest set {v['longest_active']} active slots, "
        f"{v['ns_per_slot']:.1f} ns a request slot"
        for k, v in timing.items()))
    log("phase 2: before the Hopper redesign, quoted from PERF.md and not "
        "measured in this run: " + ", ".join(
            f"{k} {ms} ms" for k, ms in SCAN_BEFORE_MS.items()))
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


def contract_check(env: Env, conv_args, ext_args, rows: dict) -> None:
    """The kernels' own final rows pass as state-in; one row outside the
    row contract of each kind makes the wrapper raise ``ValueError``
    before a launch."""
    scan = env.scan
    calls = {"conv": lambda st: scan.conv_scan(*conv_args, state=st),
             "ext": lambda st: scan.ext_scan(*ext_args, state=st)}
    for tier, call in calls.items():
        call(rows[tier])
    bad = (("conv", "lru", 0x1000), ("ext", "lru", 0x1000),
           ("ext", "size", 48), ("ext", "tags", None))
    for tier, field, value in bad:
        st = type(rows[tier])(*[x.clone() for x in rows[tier]])
        w = int(st.valid[3, 5].to(torch.int32).argmax())
        if field == "tags":
            other = (w + 1) % st.tags.shape[-1]
            st.tags[3, 5, other] = st.tags[3, 5, w]
            st.valid[3, 5, other] = True
        else:
            getattr(st, field)[3, 5, w] = value
        scan.reset_launches()
        try:
            calls[tier](st)
        except ValueError:
            if scan.launches[f"{tier}_scan"]:
                fail(f"row contract: {tier} {field} launched before raising")
            continue
        fail(f"row contract: {tier}_scan took a state row with bad {field}")
    log("phase 2: the kernels' own rows pass the row contract; a bad lru "
        "(conv, ext), size or duplicated tag (ext) raises ValueError")


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
    generation and pack, device milliseconds (CUDA events) of the copy to
    the card and of each dispatch's ``_run_packed``, whose span holds the
    host's enqueue gaps; then one profiled pass over the packed
    dispatches: device ms of the scan kernels and of the other device
    work."""
    cs, engine = env.cs, env.engine
    t0 = time.perf_counter()
    prepped = [cs._prepare(p) for p in points]
    gen_s = time.perf_counter() - t0
    groups = {}
    for i, (cfg, *_rest) in enumerate(prepped):
        groups.setdefault(cfg, []).append(i)
    pack_s = copy_ms = scan_ms = 0.0
    dispatches = 0
    packed = []
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
            packed.append((cfg, tp))
    _, us = profiled(lambda: [engine._run_packed(cfg, tp)
                              for cfg, tp in packed])
    kernel_us = sum(v for k, v in us.items() if "scan_kernel" in k)
    return dict(gen_s=gen_s, pack_s=pack_s, copy_ms=copy_ms,
                scan_ms=scan_ms, dispatches=dispatches,
                kernel_ms=kernel_us / 1e3,
                other_device_ms=(sum(us.values()) - kernel_us) / 1e3)


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
        f"{split['scan_ms']:.2f} ms over {split['dispatches']} dispatches "
        f"(CUDA events, host gaps included); profiled: scan kernels "
        f"{split['kernel_ms']:.2f} ms, other device work "
        f"{split['other_device_ms']:.2f} ms")
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


# ------------------------------------------------------------- serving pool

POOL_SERVING = dict(conv_sets=51200, ext_sets_per_chip=12800,
                    num_cache_chips=4, ways=8, compression=True,
                    predictor="bloom")
ROUNDS, ROUND_KEYS = 128, 512
PROFILED_ROUNDS = 4
# the wrappers the serving pool calls, and their kernels; the reference
# signatures tag_lookup and bdi_compress run the first and fourth kernel
# too, in phase 5 only
POOL_WRAPPERS = ("lookup_fill", "bloom_query", "bloom_record", "page_write",
                 "read_rows")
POOL_KERNELS = ("lookup_fill_kernel", "bloom_query_kernel",
                "bloom_record_kernel", "page_write_kernel",
                "block_read_kernel")
# the wrappers that work in place on host plans: their kernels are timed
# by a graph of the bare launch and replayed on copies
IN_PLACE = ("bloom_record", "lookup_fill", "page_write")


def pool_payload(keys: np.ndarray, words: int = 32) -> np.ndarray:
    """Page payloads of ``keys`` (as ``tests/torch_parity.pool_payload``,
    which made the golden pool file): a HIGH, LOW or UNCOMP block
    (``key % 3``) around a key-derived base, wrapping mod 2^32."""
    k = np.asarray(keys, np.int64)[:, None]
    i = np.arange(words, dtype=np.int64)[None, :]
    base = (k * 0x9E3779B1) & 0xFFFFFFFF
    step = np.asarray([1, 1000, 0x01000193])[k % 3]
    return ((base + (i - words // 2) * step) % (1 << 32)).astype(np.uint32)


def exact(kernel, plain, ctx: str) -> int:
    """Kernel outputs vs plain outputs, identical; returns the max abs
    difference (0)."""
    kernel = kernel if isinstance(kernel, tuple) else (kernel,)
    plain = plain if isinstance(plain, tuple) else (plain,)
    for i, (k, p) in enumerate(zip(kernel, plain)):
        if k.dtype != p.dtype or not torch.equal(k, p):
            bad = (k != p).nonzero()[:5].tolist()
            fail(f"{ctx}: output {i} differs from the plain version at {bad}")
    return max(int((k.long() - p.long()).abs().max()) if k.numel() else 0
               for k, p in zip(kernel, plain))


def bytes_bound(n_bytes: float, n_ops: float) -> tuple:
    """(least ms, what bounds it): bytes over the memory rate against
    operations over the float32 peak, the larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pool_bound(name: str, args) -> tuple:
    """``bytes_bound`` of one call of pool wrapper ``name`` on ``args``:
    each input read once and each output written once (the block reads
    count only the rows they select, by this call's rows; the Bloom query
    one filter row and one mask row a query; the record the filter rows
    and counts of the sets this batch touches, read and written), against
    about 4 operations a way, 6 a hash or segment and 1-2 a word read."""
    if name == "tag_lookup":
        s, w = args[0].shape
        return bytes_bound(s * w * (4 + 1 + 4 + 4) + s * 12, 4 * s * w)
    if name == "lookup_fill":      # the store, plan and records; the rows
        tags, _, _, sets, _ = args              # of the sets asked about
        (s, w), k = tags.shape, len(sets)
        runs = np.unique(sets, return_counts=True)[1]
        r = min(4, int(runs.max()))             # the pool's 4 rounds a batch
        return bytes_bound(s * w * 9 + (s + 1 + 2 * k) * 4 + k * 20
                           + len(runs) * w * 9, 4 * s * w * r)
    if name == "page_write":       # keys, the probed rows, pages in and out
        tags, _, data, level, _, sets, _, _ = args
        n, w, words = len(sets), tags.shape[1], data.shape[2]
        return bytes_bound(n * (8 + 5 * w + 8 * words
                                + 8 * (level is not None)),
                           n * (2 * w + 6 * words))
    if name == "bloom_query":                  # (+ 4 B a row index)
        q, words = args[1].shape[0], args[0].shape[1]
        return bytes_bound(q * (words * 8 + 8 + 4 * (len(args) > 2)),
                           q * 3 * 6)
    if name == "bloom_record":
        bf1, _, _, sets, _, _ = args
        k, words, runs = len(sets), bf1.shape[1], len(np.unique(sets))
        return bytes_bound(k * 4 + (2 * runs + 1) * 4
                           + runs * (2 * 2 * words * 4 + 2 * 4),
                           k * (3 * 6 + 6 * words))
    if name == "bdi_compress":
        n = args[0].shape[0]
        return bytes_bound(n * (128 + 136), n * 32 * 6)
    if name == "bdi_decompress":               # level, base, payload
        n, words = args[2].shape
        return bytes_bound(n * (8 + 8 * words), n * words * 2)
    if name == "read_rows":
        conv, ext, _, _, tier, set_idx, way = args
        n, words = tier.shape[0], conv.shape[2]
        read = 0                                # rows, + level/base on ext
        for t, store in enumerate((conv, ext)):
            ok = ((tier == t) & (set_idx >= 0) & (set_idx < store.shape[0])
                  & (way >= 0) & (way < store.shape[1]))
            read += int(ok.sum()) * (4 * words + 8 * t)
        return bytes_bound(n * (12 + 4 * words) + read, n * words * 2)
    s, _, words = args[0].shape
    if name == "gather_blocks":
        return bytes_bound(s * (4 + 8 * words), s * words)
    return bytes_bound(s * (12 + 8 * words), s * words * 2)


def u32(rng, shape, dev, hi=1 << 32) -> torch.Tensor:
    a = rng.integers(0, hi, size=shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(dev)


def bdi_blocks(rng, n: int, dev) -> torch.Tensor:
    """n blocks of all three levels, with the boundary deltas and bases
    near 2^32."""
    base = rng.integers(0, 1 << 32, size=(n, 1), dtype=np.int64)
    base[::4] = (1 << 32) - 2
    step = np.asarray([1, 1000, 1 << 24])[rng.integers(0, 3, size=(n, 1))]
    x = base + rng.integers(-127, 128, size=(n, 32)) * step // 127
    x[:, 0] = base[:, 0]
    edge = np.asarray([-129, -128, 127, 128, -32769, -32768, 32767, 32768])
    m = 8 * (n // 8)
    x[:m, 5] = base[:m, 0] + np.tile(edge, n // 8)
    a = (x % (1 << 32)).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(dev)


def phase_pool_kernels(env: Env, dev) -> dict:
    """Phase 5: each pool kernel vs its plain version at full-scale
    shapes, and its time against its plain version's and its bound."""
    kp = env.pool
    rng = np.random.default_rng(0)
    out = {}
    # tag lookup over the serving pool's conventional store (W = 8), and
    # W = 32 (one set per warp)
    for w in (8, 32):
        s = POOL_SERVING["conv_sets"]
        valid = torch.from_numpy(rng.random((s, w)) < 0.7).to(dev)
        lru = u32(rng, (s, w), dev, hi=1 << 12)
        lru[:, 0] = 0
        lru[::3, -1] = 0xFFF
        req = u32(rng, (s,), dev, hi=6)
        req[::5] = 7                                 # certain misses
        args = (u32(rng, (s, w), dev, hi=6), valid, lru, req)
        err = exact(kp.tag_lookup(*args), kp.tag_lookup_plain(*args),
                    f"tag_lookup ({s}, {w})")
        if w == 8:
            out["tag_lookup"] = dict(
                err=err, shape=[s, w],
                **times(lambda: kp.tag_lookup(*args),
                        lambda: kp.tag_lookup_plain(*args), 50, 5),
                bound=pool_bound("tag_lookup", args))
    # bloom query, 4096 queries of 8-word filters, half of them members
    q, words = 4096, 8
    filters = u32(rng, (q, words), dev) & u32(rng, (q, words), dev)
    tags = u32(rng, (q,), dev)
    filters[::2] |= kp.bloom_query_plain(filters, tags)[1][::2]
    err = exact(kp.bloom_query(filters, tags),
                kp.bloom_query_plain(filters, tags), "bloom_query")
    out["bloom_query"] = dict(
        err=err, shape=[q, words],
        **times(lambda: kp.bloom_query(filters, tags),
                lambda: kp.bloom_query_plain(filters, tags), 50, 5),
        bound=pool_bound("bloom_query", (filters, tags)))
    # a batch's conventional rounds and fills: 512 requests over phase 8's
    # (51200, 8) store, one set taking 6 of them (4 rounds)
    largs = fill_args(rng, POOL_SERVING["conv_sets"], POOL_SERVING["ways"],
                      512, dev)
    out["lookup_fill"] = dict(
        err=inplace_exact(env, "lookup_fill", largs, "lookup_fill"),
        shape=[*largs[0].shape, len(largs[3])],
        **inplace_times(env, "lookup_fill", largs, 50, 5),
        bound=pool_bound("lookup_fill", largs))
    # BDI: 65 536 blocks of every level, and the round trip
    n = 65536
    blocks = bdi_blocks(rng, n, dev)
    comp = kp.bdi_compress(blocks)
    err = exact(comp, kp.bdi_compress_plain(blocks), "bdi_compress")
    levels = sorted(set(comp[0].tolist()))
    if levels != [0, 1, 2]:
        fail(f"bdi_compress: levels {levels}, expected all three")
    back = kp.bdi_decompress(*comp)
    err_d = exact(back, kp.bdi_decompress_plain(*comp), "bdi_decompress")
    exact(back, blocks, "bdi round trip")
    out["bdi_compress"] = dict(
        err=err, shape=[n, 32],
        **times(lambda: kp.bdi_compress(blocks),
                lambda: kp.bdi_compress_plain(blocks), 50, 5),
        bound=pool_bound("bdi_compress", (blocks,)))
    # write_page of 4096 pages of every level into phase 8's extended
    # store (51200, 32) with BDI, each probing its set
    wargs = write_args(rng, 4096, dev)
    out["page_write"] = dict(
        err=inplace_exact(env, "page_write", wargs, "page_write"),
        shape=[*wargs[2].shape, len(wargs[5])],
        **inplace_times(env, "page_write", wargs, 50, 1),
        bound=pool_bound("page_write", wargs))
    del wargs
    out["bdi_decompress"] = dict(
        err=err_d, shape=[n, 32],
        **times(lambda: kp.bdi_decompress(*comp),
                lambda: kp.bdi_decompress_plain(*comp), 50, 5),
        bound=pool_bound("bdi_decompress", comp))
    # block read: 4096 rows of (4096, 32, 32), plain and fused
    s, w = 4096, 32
    data = u32(rng, (s, w, 32), dev)
    way = torch.from_numpy(rng.integers(0, w, size=s).astype(np.int32)
                           ).to(dev)
    level = torch.from_numpy(rng.integers(0, 3, size=s).astype(np.int32)
                             ).to(dev)
    base = u32(rng, (s,), dev)
    err = exact(kp.gather_blocks(data, way), kp.gather_blocks_plain(data, way),
                "gather_blocks")
    fargs = (data, way, level, base)
    err_f = exact(kp.cached_block_read(*fargs),
                  kp.cached_block_read_plain(*fargs), "cached_block_read")
    rows = torch.arange(s, device=dev)
    out["gather_blocks"] = dict(
        err=max(err, err_f), shape=[s, w, 32],
        **times(lambda: kp.gather_blocks(data, way),
                lambda: kp.gather_blocks_plain(data, way), 50, 5,
                library=lambda: data[rows, way]),
        bound=pool_bound("gather_blocks", (data, way)),
        fused_ms=device_ms(lambda: kp.cached_block_read(*fargs), 50),
        fused_plain_ms=device_ms(
            lambda: kp.cached_block_read_plain(*fargs), 5),
        fused_bound=pool_bound("cached_block_read", fargs))
    # the predictor's query by row of the full-scale pool's (51200, 8)
    # filter store, half of the queries members
    n_sets = POOL_SERVING["ext_sets_per_chip"] * POOL_SERVING[
        "num_cache_chips"]
    store = u32(rng, (n_sets, words), dev) & u32(rng, (n_sets, words), dev)
    rows = torch.from_numpy(rng.integers(0, n_sets, size=q).astype(np.int32)
                            ).to(dev)
    store[rows[::2].long()] |= kp.bloom_query_plain(store, tags, rows)[1][::2]
    qargs = (store, tags, rows)
    out["bloom_query_rows"] = dict(
        err=exact(kp.bloom_query(*qargs), kp.bloom_query_plain(*qargs),
                  "bloom_query by row"), shape=[n_sets, words, q],
        **times(lambda: kp.bloom_query(*qargs),
                lambda: kp.bloom_query_plain(*qargs), 50, 5),
        bound=pool_bound("bloom_query", qargs))
    # a batch's Bloom records: 4096 keys over the same 51 200 sets, one
    # set taking 256 of them, a fifth of the tags repeated
    rec = record_args(rng, n_sets, 4096, words, POOL_SERVING["ways"], dev)
    out["bloom_record"] = dict(
        err=inplace_exact(env, "bloom_record", rec, "bloom_record"),
        shape=[n_sets, words, 4096],
        **inplace_times(env, "bloom_record", rec, 50, 1),
        bound=pool_bound("bloom_record", rec))
    # read_rows: 4096 rows of both tiers and tier 2 from phase 8's stores
    # (52 MB conventional, 210 MB extended: past the 50 MB L2)
    rargs = read_args(rng, 4096, dev)
    conv_rows = [c[rargs[4] == 0].long() for c in rargs[5:]]
    out["read_rows"] = dict(
        err=exact(kp.read_rows(*rargs), kp.read_rows_plain(*rargs),
                  "read_rows"), shape=[list(a.shape) for a in rargs[:2]],
        **times(lambda: kp.read_rows(*rargs),
                lambda: kp.read_rows_plain(*rargs), 50, 5,
                library=lambda: rargs[0][conv_rows[0], conv_rows[1]]),
        bound=pool_bound("read_rows", rargs))
    del rargs, conv_rows
    log("phase 5: pool kernels == plain (tolerance 0): " + ", ".join(
        f"{k} {v['shape']} {v['ms']:.5f} ms on the card, {v['call_ms']:.4f} "
        f"ms a call (plain {v['plain_ms']:.4f} ms, bound "
        f"{v['bound'][0]:.5f} ms)" for k, v in out.items())
        + f"; fused read {out['gather_blocks']['fused_ms']:.5f} ms, "
        f"library gather {out['gather_blocks']['library_ms']:.5f} ms")
    # the floor of a launch: one one-element CUDA op, by graph replay
    one = torch.zeros(1, device=dev)
    out["launch_floor_ms"] = device_ms(lambda: one.add_(1), 50)
    log(f"phase 5: launch floor (one-element add_): "
        f"{out['launch_floor_ms']:.5f} ms on the card")
    return out


def record_args(rng, n_sets: int, k: int, words: int, ways: int, dev):
    """``bloom_record``'s arguments: filters and MRU counts of ``n_sets``
    sets on the card, ``k`` keys with one set taking every 16th and a
    fifth of the tags repeated."""
    sets = rng.integers(0, n_sets, size=k)
    sets[::16] = sets[0]
    tags = rng.integers(0, 1 << 32, size=k, dtype=np.uint64).astype(np.uint32)
    tags[3::5] = tags[rng.integers(0, 3, size=len(tags[3::5]))]
    n_mru = torch.from_numpy(rng.integers(0, ways, size=n_sets).astype(
        np.int32)).to(dev)
    return (u32(rng, (n_sets, words), dev) & u32(rng, (n_sets, words), dev),
            u32(rng, (n_sets, words), dev) & u32(rng, (n_sets, words), dev),
            n_mru, sets, tags, ways)


def copy_arg(a):
    return a.clone() if isinstance(a, torch.Tensor) else (
        a.copy() if isinstance(a, np.ndarray) else a)


def fill_args(rng, s: int, w: int, k: int, dev):
    """``lookup_fill``'s arguments: an (s, w) store on the card (few tag
    values, every other set full, LRU ties, a valid tag 0 in some sets)
    and ``k`` requests, one set taking 6 of them."""
    tags = u32(rng, (s, w), dev, hi=6)
    valid = torch.from_numpy(rng.random((s, w)) < 0.7).to(dev)
    valid[::2] = True
    tags[5::9, 0] = 0
    lru = u32(rng, (s, w), dev, hi=1 << 12)
    lru[::3] = lru[::3, :1]
    sets = rng.integers(0, s, size=k)
    sets[: 6 * 7: 7] = sets[0]
    req = rng.integers(0, 8, size=k).astype(np.uint32)
    return tags, valid, lru, sets, req


def write_args(rng, n: int, dev):
    """``page_write``'s arguments on phase 8's extended store with BDI:
    ``n`` distinct (set, tag) keys, most held by their set, and pages of
    every BDI level."""
    sets, ways = POOL_SERVING["conv_sets"], 4 * POOL_SERVING["ways"]
    keys = rng.choice(sets * 5, size=n, replace=False)
    return (u32(rng, (sets, ways), dev, hi=5),
            torch.from_numpy(rng.random((sets, ways)) < 0.8).to(dev),
            u32(rng, (sets, ways, 32), dev),
            torch.from_numpy(rng.integers(0, 3, size=(sets, ways)).astype(
                np.int32)).to(dev),
            u32(rng, (sets, ways), dev), keys // 5,
            (keys % 5).astype(np.uint32),
            bdi_blocks(rng, n, "cpu").numpy().view(np.uint32))


def inplace_outputs(name: str, args, result) -> tuple:
    """What an in-place wrapper leaves: the state it changes (and its
    records, for ``lookup_fill``)."""
    if name == "lookup_fill":
        return (result, *args[:3])
    if name == "page_write":
        return tuple(a for a in args[2:5] if a is not None)
    return args[:3]


def inplace_exact(env: Env, name: str, args, ctx: str) -> int:
    """An in-place wrapper and its plain version on two copies of
    ``args``: what they leave must be identical."""
    kp = env.pool
    a, b = [tuple(copy_arg(x) for x in args) for _ in range(2)]
    got = inplace_outputs(name, a, getattr(kp, name)(*a))
    want = inplace_outputs(name, b, getattr(kp, name + "_plain")(*b))
    return exact(got, want, ctx)


def bare_launch(env: Env, name: str, args):
    """A closure that launches in-place wrapper ``name``'s kernel on
    ``args`` with its host plan copied to the card beforehand: the part of
    the wrapper a CUDA graph can capture."""
    kp, b = env.pool, env.build
    dev = args[0].device
    if name == "bloom_record":
        bf1, bf2, n_mru, sets, tags, ways = args
        plan, runs = kp.record_plan(np.asarray(sets, np.int64),
                                    np.asarray(tags, np.uint32))
        plan = torch.from_numpy(plan).to(dev)
        return lambda: b.raise_on(kp._lib().bloom_record_launch(
            b.ptr(bf1), b.ptr(bf2), b.ptr(n_mru), b.ptr(plan), runs,
            bf1.shape[1], ways, b.stream(dev)), "bloom_record")
    if name == "lookup_fill":
        tags, valid, lru, sets, req = args
        plan, n_rounds = kp.fill_plan(np.asarray(sets, np.int64),
                                      np.asarray(req, np.uint32),
                                      tags.shape[0])
        plan = torch.from_numpy(plan).to(dev)
        rec = torch.empty((len(kp.REC_FIELDS), len(sets)),
                          dtype=torch.int32, device=dev)
        return lambda: kp._launch_lookup(
            "lookup_fill", tags, valid, lru, lru, plan, len(sets), n_rounds,
            rec, None, None, None)
    tags, valid, data, level, base, sets, ptags, pages = args
    keys = torch.from_numpy(np.concatenate([
        np.asarray(sets, np.int64), np.asarray(ptags, np.uint32).view(
            np.int32)]).astype(np.int32)).to(dev)
    if isinstance(pages, np.ndarray):
        pages = torch.from_numpy(pages.view(np.int32)).to(dev)
    return lambda: kp._launch_write("page_write", tags, valid, data, level,
                                    base, keys, pages, len(sets))


def inplace_times(env: Env, name: str, args, reps: int,
                  plain_reps: int) -> dict:
    """``times`` of an in-place wrapper on a copy of ``args``: the
    kernel's device ms by graph replay of its bare launch (a graph cannot
    capture the wrapper's copy from the host), the wrapper's ms a call
    back to back (host plan and copy included), and the plain version's ms
    back to back.  Each call works on the state the previous one left."""
    kp = env.pool
    call = tuple(copy_arg(x) for x in args)
    kernel, plain = getattr(kp, name), getattr(kp, name + "_plain")
    return dict(ms=device_ms(bare_launch(env, name, call), reps),
                call_ms=timed_cuda(lambda: kernel(*call), reps),
                plain_ms=timed_cuda(lambda: plain(*call), plain_reps),
                library_ms=None)


def read_args(rng, n: int, dev):
    """``read_rows``' arguments on phase 8's stores: ``n`` rows a third of
    each tier, ways within their store."""
    sets, conv_ways = POOL_SERVING["conv_sets"], POOL_SERVING["ways"]
    ext_ways = 4 * conv_ways
    tier = rng.integers(0, 3, size=n)
    way = np.where(tier == 0, rng.integers(0, conv_ways, size=n),
                   rng.integers(0, ext_ways, size=n))
    cols = [torch.from_numpy(c.astype(np.int32)).to(dev)
            for c in (tier, rng.integers(0, sets, size=n), way)]
    level = torch.from_numpy(rng.integers(0, 3, size=(sets, ext_ways))
                             .astype(np.int32)).to(dev)
    return (u32(rng, (sets, conv_ways, 32), dev),
            u32(rng, (sets, ext_ways, 32), dev), level,
            u32(rng, (sets, ext_ways), dev), *cols)


def replay_golden_cell(env: Env, cell: dict, dev) -> dict:
    """``tests/test_torch_golden_pool.py``'s procedure on the card."""
    kv = env.kv
    pool = kv.MorpheusPagePool(kv.PoolConfig(**cell["config"]), dev)
    plans = reads = 0
    for keys in cell["batches"]:
        keys = np.asarray(keys, np.uint32)
        plan = pool.lookup_batch(keys)
        plans = zlib.crc32(b"".join(np.ascontiguousarray(x, np.int32)
                                    .tobytes() for x in plan), plans)
        fetched = keys[plan.tier == 2]
        for k, pay in zip(fetched, pool_payload(fetched,
                                                pool.cfg.page_words)):
            pool.write_page(int(k), pay)
        got = pool.read_pages(plan).cpu().numpy().view(np.uint32)
        reads = zlib.crc32(np.ascontiguousarray(got).tobytes(), reads)
    st = kv.pool_to_numpy(pool)
    state = 0
    for name in kv.STATE_FIELDS:
        state = zlib.crc32(np.ascontiguousarray(st[name]).tobytes(), state)
    return {"stats": dict(pool.stats._asdict()), "plans_crc": plans,
            "reads_crc": reads, "state_crc": state}


def phase_golden_pool(env: Env, dev) -> None:
    cells = json.loads(GOLDEN_POOL.read_text())["cells"]
    for cell in cells:
        got = replay_golden_cell(env, cell, dev)
        want = {k: cell[k] for k in got}
        if got != want:
            fail(f"golden pool {cell['name']}: {got} != {want}")
    log(f"phase 6: golden pool: {len(cells)} cells replayed on the card "
        f"equal the reference's stats and plan/read/state crcs")


class PathCalls:
    """While entered, wraps the pool wrappers under the names the serving
    pool calls them by (``kernels.ops``): counts each call by its input
    shapes (the values of arguments that have none, and keyword
    arguments) and keeps a copy of the inputs of the first call of each
    (before a wrapper that works in place changes them), so the calls the
    path made can be replayed against the plain versions afterwards.  The
    wrappers still count their own launches."""

    def __init__(self, ops, names=POOL_WRAPPERS):
        self.ops, self.names = ops, names
        self.calls = {}         # (name, input shapes) -> calls
        self.inputs = {}        # (name, input shapes) -> first call's inputs

    def __enter__(self):
        self.saved = {n: getattr(self.ops, n) for n in self.names}
        for n, fn in self.saved.items():
            setattr(self.ops, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.ops, n, fn)

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            key = (name, tuple(tuple(a.shape) if hasattr(a, "shape") else a
                               for a in args),
                   tuple(sorted(kwargs.items())))
            if key not in self.calls:
                self.inputs[key] = tuple(copy_arg(a) for a in args)
                self.calls[key] = 0
            self.calls[key] += 1
            return fn(*args, **kwargs)
        return call


def drive(env: Env, ctx: str, serve) -> dict:
    """Run ``serve()`` (one serving cell) with every pool count set to 0
    just before and read just after; fail unless each wrapper of the path
    launched its kernel and no plain version ran."""
    kp = env.pool
    with PathCalls(env.ops) as calls:
        torch.cuda.synchronize()
        kp.reset_launches()
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, plain = dict(kp.launches), dict(kp.plain_runs)
    for name in POOL_WRAPPERS:
        if counts[name] <= 0:
            fail(f"{ctx}: kernel {name} was not launched")
    if any(plain.values()):
        fail(f"{ctx}: plain versions ran {plain}")
    return {"wall_s": wall, "launches": counts, "calls": calls}


def profiled_window(serve, kernels=POOL_KERNELS) -> dict:
    """Host wall seconds and device milliseconds (``torch.profiler``: the
    named ``kernels``, and all kernels and copies) of ``serve()``."""
    wall, us = profiled(serve)
    k_us = sum(v for k, v in us.items() if any(n in k for n in kernels))
    return {"wall_s": wall, "kernels_ms": k_us / 1e3,
            "device_busy_ms": sum(us.values()) / 1e3, "measured": bool(us)}


def window_text(w: dict, what: str, kernels: str = "the pool kernels"
                ) -> str:
    if not w["measured"]:
        return (f"profiled window of {what}: host {w['wall_s']:.3f} s, "
                f"device time not measured (torch.profiler recorded no "
                f"device activity)")
    share = 100 * w["kernels_ms"] / max(w["device_busy_ms"], 1e-9)
    return (f"profiled window of {what}: host {w['wall_s']:.4f} s, device "
            f"{w['device_busy_ms']:.3f} ms in all kernels and copies, "
            f"{w['kernels_ms']:.3f} ms ({share:.2f} %) in {kernels}")


# The reference serving engine's pool and access pattern
# (``src/repro/serving/engine.py``: ``Engine.__init__`` builds this pool,
# ``Engine.run`` consults it one page key at a time).
ENGINE_POOL = dict(conv_sets=64, ext_sets_per_chip=32, num_cache_chips=4,
                   ways=4)
PAGE_TOKENS = 16
SYSTEM_PROMPTS, SYSTEM_PAGES = 32, 4     # shared prefixes, Zipf-popular
TURN_PAGES, MAX_TURNS, LIVE_CHATS = 4, 8, 64
ENGINE_REQUESTS, ENGINE_PROFILED = 900, 40


def prefix_hash(tokens) -> int:
    """The engine's prefix hash: blake2b-64 of the int32 token bytes."""
    h = hashlib.blake2b(np.asarray(tokens, np.int32).tobytes(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little")


def digest_page(prefix) -> np.ndarray:
    """The engine's page payload: two salted 64-byte blake2b digests of
    the prefix's ``repr`` (32 words, almost always BDI ``UNCOMP``)."""
    raw = bytes(repr(prefix), "utf8")
    d = (hashlib.blake2b(raw, digest_size=64, salt=b"pg0").digest()
         + hashlib.blake2b(raw, digest_size=64, salt=b"pg1").digest())
    return np.frombuffer(d, dtype=np.uint32).copy()


def chat_prompts(n: int, seed: int = 0):
    """``n`` prompts of a chat service: each starts with one of
    ``SYSTEM_PROMPTS`` system prompts (Zipf-popular) and either opens a
    conversation with a new user turn or continues one of the
    ``LIVE_CHATS`` most recent conversations (its previous prompt plus a
    reply and a new turn) until it reaches ``MAX_TURNS`` turns."""
    rng = np.random.default_rng(seed)
    vocab = 151_936                                  # qwen3's vocabulary
    systems = [rng.integers(0, vocab, SYSTEM_PAGES * PAGE_TOKENS).tolist()
               for _ in range(SYSTEM_PROMPTS)]
    pop = 1.0 / np.arange(1, SYSTEM_PROMPTS + 1)
    pop /= pop.sum()
    chats = []                                       # [prompt, turns]
    for _ in range(n):
        turn = rng.integers(0, vocab, TURN_PAGES * PAGE_TOKENS).tolist()
        if chats and rng.random() < 0.6:
            i = int(rng.integers(max(0, len(chats) - LIVE_CHATS),
                                 len(chats)))
            prompt, turns = chats.pop(i)
            prompt = prompt + turn
            turns += 1
        else:
            prompt, turns = systems[rng.choice(SYSTEM_PROMPTS, p=pop)] + turn, 1
        if turns < MAX_TURNS:
            chats.append((prompt, turns))
        yield prompt


def serve_request(pool, page_key, prompt, installed: dict, ctx: str) -> int:
    """``Engine.run``'s page-cache consultation for one prompt: one
    ``lookup_batch`` per page key ``page_key(prefix hash, 0, page)``; a
    backing fetch installs the prefix's digest; a hit is read back and
    held to what was installed under its key.  Returns the number of
    ``write_page`` calls."""
    writes = 0
    for pg in range(len(prompt) // PAGE_TOKENS):
        prefix = prompt[: (pg + 1) * PAGE_TOKENS]
        key = page_key(prefix_hash(prefix), 0, pg)
        plan = pool.lookup_batch(np.asarray([key], np.uint32))
        if plan.tier[0] == 2:
            installed[key] = digest_page(prefix)
            pool.write_page(key, installed[key])
            writes += 1
            continue
        got = pool.read_pages(plan).cpu().numpy().view(np.uint32)[0]
        if not np.array_equal(got, installed[key]):
            fail(f"{ctx}: key {key} (tier {int(plan.tier[0])}) read back "
                 f"another page")
    return writes


def phase_engine_serving(env: Env, dev) -> dict:
    """Phase 7: the serving path as its one caller in the repository
    drives it, through the kernels; this is the main path whose launches
    the kernels line reports."""
    kv = env.kv
    prompts = list(chat_prompts(ENGINE_REQUESTS + ENGINE_PROFILED))
    pool = kv.MorpheusPagePool(kv.PoolConfig(**ENGINE_POOL), dev)
    rec = pool.attach_recorder(kv.TraceRecorder(1 << 20))
    installed = {}
    lookups = sum(len(p) // PAGE_TOKENS for p in prompts[:ENGINE_REQUESTS])
    writes = []

    def serve():
        for i, prompt in enumerate(prompts[:ENGINE_REQUESTS]):
            writes.append(serve_request(pool, kv.page_key, prompt, installed,
                                        f"engine request {i}"))
    run = drive(env, "engine serving path", serve)
    stats, events, hit_rate = pool.stats, rec.counts(), pool.hit_rate()
    distinct = len(installed)
    cap = (ENGINE_POOL["conv_sets"] * ENGINE_POOL["ways"]
           + pool.ext_tags.shape[0] * pool.ext_tags.shape[1])
    if not (stats.conv_hits and stats.ext_hits and events["evict"]):
        fail(f"engine serving path: no hit on a tier or no eviction "
             f"({stats}, {events})")
    if stats.lookups != lookups:
        fail(f"engine serving path: {stats.lookups} lookups, expected "
             f"{lookups}")
    # one lookup_fill a conventional lookup, one predictor query and one
    # Bloom record an extended lookup, one page_write a write_page, one
    # block read a hit (each read_pages call), and no reference-signature
    # launch
    ext_lookups = stats.ext_hits + stats.ext_false_pos + stats.ext_pred_miss
    conv_lookups = stats.conv_hits + stats.conv_misses
    hits = stats.conv_hits + stats.ext_hits
    want = {"lookup_fill": conv_lookups, "bloom_query": ext_lookups,
            "bloom_record": ext_lookups, "page_write": sum(writes),
            "read_rows": hits, "tag_lookup": 0, "bdi_compress": 0}
    got = {k: run["launches"][k] for k in want}
    if got != want:
        fail(f"engine serving path: launches {got}, expected {want}")
    window = profiled_window(lambda: [
        serve_request(pool, kv.page_key, p, installed, "profiled request")
        for p in prompts[ENGINE_REQUESTS:]])
    keys_s = lookups / run["wall_s"]
    log(f"phase 7: engine traffic: {ENGINE_REQUESTS} chat prompts, "
        f"{lookups} page lookups one key a call, {distinct} distinct "
        f"pages against {cap} slots, in {run['wall_s']:.3f} s "
        f"({keys_s:.1f} keys/s); hit rate {hit_rate:.4f} ({stats}); "
        f"events {json.dumps(events)}; launches by wrapper "
        f"{json.dumps(run['launches'])}, plain runs 0; lookup_fill launches "
        f"{got['lookup_fill']} for {conv_lookups} conventional lookups, Bloom "
        f"launches {got['bloom_query'] + got['bloom_record']} (a query and a "
        f"record each) for {ext_lookups} extended lookups, page_write "
        f"launches {got['page_write']} for {sum(writes)} write_page calls, "
        f"block reads {got['read_rows']} for {hits} hits; "
        + window_text(window, f"{ENGINE_PROFILED} more prompts"))
    return dict(run, keys_per_s=keys_s, lookups=lookups,
                writes=sum(writes), distinct=distinct, slots=cap,
                hit_rate=hit_rate, stats=stats._asdict(),
                events=events, window=window)


def serve_round(pool, keys: np.ndarray, pages: np.ndarray,
                index: dict, ctx: str) -> None:
    """One round: route the keys, install every fetched page, read every
    hit back and hold it to what was installed."""
    plan = pool.lookup_batch(keys)
    rows = np.asarray([index[int(k)] for k in keys])
    fetched = plan.tier == 2
    for k, r in zip(keys[fetched], rows[fetched]):
        pool.write_page(int(k), pages[r])
    if not fetched.all():
        got = pool.read_pages(plan).cpu().numpy().view(np.uint32)
        bad = np.nonzero((got != pages[rows]).any(axis=1) & ~fetched)[0]
        if bad.size:
            fail(f"{ctx}: key {int(keys[bad[0]])} read back another page "
                 f"({bad.size} of {int((~fetched).sum())} hits)")


def phase_full_scale(env: Env, dev) -> dict:
    """Phase 8: the pool's state at full scale (a conventional tier the
    size of the H100's L2) under a batched synthetic mix, through the
    kernels.  The mix fills the pool only in part and evicts nothing, so
    its keys/s is no user's workload; the cell is there to run every
    kernel at the full store's shapes with the state on the card."""
    kv = env.kv
    cfg = kv.PoolConfig(**POOL_SERVING)
    universe = np.asarray([kv.page_key(seq, layer, page)
                           for seq in range(32) for layer in range(36)
                           for page in range(16)], np.uint32)
    pages = pool_payload(universe)
    index = {int(k): i for i, k in enumerate(universe)}
    rng = np.random.default_rng(0)
    traffic = [universe[rng.integers(0, len(universe), size=ROUND_KEYS)]
               for _ in range(ROUNDS + PROFILED_ROUNDS)]
    pool = kv.MorpheusPagePool(cfg, dev)

    def serve():
        for i, keys in enumerate(traffic[:ROUNDS]):
            serve_round(pool, keys, pages, index, f"full-scale round {i}")
    run = drive(env, "full-scale pool", serve)
    stats, hit_rate = pool.stats, pool.hit_rate()
    if not (stats.conv_hits and stats.ext_hits):
        fail(f"full-scale pool: a tier never hit ({stats})")
    n = run["launches"]
    bloom = n["bloom_query"] + n["bloom_record"]
    if bloom > 2 * ROUNDS or n["read_rows"] > ROUNDS or \
            n["lookup_fill"] > ROUNDS or n["tag_lookup"] or n["bdi_compress"]:
        fail(f"full-scale pool: {bloom} Bloom launches (at most "
             f"{2 * ROUNDS}), {n['read_rows']} block reads and "
             f"{n['lookup_fill']} lookup_fill launches (at most {ROUNDS} "
             f"each), {n['tag_lookup']} tag_lookup and {n['bdi_compress']} "
             f"bdi_compress launches (none) in {ROUNDS} rounds")
    window = profiled_window(lambda: [
        serve_round(pool, keys, pages, index, "profiled round")
        for keys in traffic[ROUNDS:]])
    keys_s = ROUNDS * ROUND_KEYS / run["wall_s"]
    log(f"phase 8: full-scale pool, batched mix: {ROUNDS} x {ROUND_KEYS} "
        f"keys in {run['wall_s']:.3f} s ({keys_s:.1f} keys/s), hit rate "
        f"{hit_rate:.4f} ({stats}); launches by wrapper "
        f"{json.dumps(run['launches'])}, plain runs 0; Bloom launches "
        f"{bloom}, lookup_fill launches {n['lookup_fill']}, page_write "
        f"launches {n['page_write']}, block reads {n['read_rows']}; "
        + window_text(window, f"{PROFILED_ROUNDS} more rounds"))
    return dict(run, keys_per_s=keys_s, hit_rate=hit_rate,
                stats=stats._asdict(), window=window)


def call_rows(name: str, args) -> int:
    """The rows (queries, keys, blocks, sets) of one pool-wrapper call."""
    i = {"bloom_query": 1, "bloom_record": 3, "read_rows": 4,
         "lookup_fill": 3, "page_write": 5}.get(name, 0)
    return args[i].shape[0]


def replay_path(env: Env, cell: str, calls: PathCalls) -> dict:
    """Replay every (wrapper, shapes) call a serving cell made against the
    plain version on the same inputs (tolerance 0), and time the most
    frequent and the largest shape of each wrapper."""
    kp = env.pool
    out = {}
    for (name, shapes, _), args in calls.inputs.items():
        if not call_rows(name, args):
            continue
        ctx = f"{cell}: {name} {shapes}"
        if name in IN_PLACE:
            err = inplace_exact(env, name, args, ctx)
        else:
            err = exact(getattr(kp, name)(*args),
                        getattr(kp, name + "_plain")(*args), ctx)
        row = out.setdefault(name, {"err": 0, "shapes": 0, "timed": []})
        row["err"] = max(row["err"], err)
        row["shapes"] += 1
    for name, row in out.items():
        keys = [k for k in calls.inputs if k[0] == name
                and call_rows(name, calls.inputs[k])]
        top = max(keys, key=lambda k: calls.calls[k])
        big = max(keys, key=lambda k: call_rows(name, calls.inputs[k]))
        for key in dict.fromkeys((top, big)):
            args = calls.inputs[key]
            kernel = getattr(kp, name)
            plain = getattr(kp, name + "_plain")
            library = None
            if name == "read_rows" and bool((args[4] == 0).any()):
                # the conventional rows' gather, where the call has some
                conv = [c[args[4] == 0].long() for c in args[5:]]
                library = (lambda a=args, c=conv: a[0][c[0], c[1]])
            t = (inplace_times(env, name, args, 50, 5) if name in IN_PLACE
                 else times(lambda a=args: kernel(*a),
                            lambda a=args: plain(*a), 50, 5,
                            library=library))
            row["timed"].append(dict(
                cell=cell, shape=[list(s) if isinstance(s, tuple) else s
                                  for s in key[1]],
                rows=call_rows(name, args), launches=calls.calls[key], **t,
                bound=pool_bound(name, args)))
    return out


def phase_path_shapes(env: Env, cells: dict) -> dict:
    """Phase 9: each pool kernel against its plain version at the shapes
    the serving cells gave it."""
    out = {c: replay_path(env, c, run["calls"]) for c, run in cells.items()}
    log("phase 9: pool kernels == plain at the serving path's shapes "
        "(tolerance 0): " + "; ".join(
            f"{c}: " + ", ".join(
                f"{name} {row['shapes']} shapes" + "".join(
                    f" [{t['rows']} rows x{t['launches']}: {t['ms']:.5f} ms "
                    f"on the card, plain {t['plain_ms']:.5f} ms, bound "
                    f"{t['bound'][0]:.3g} ms]" for t in row["timed"])
                for name, row in rows.items())
            for c, rows in out.items()))
    return out


# ------------------------------------------------------------- attention

ATT_WRAPPERS = ("decode_attention", "flash_attention")
ATT_KERNELS = ("flash_kernel", "decode_partial_kernel",
               "decode_combine_kernel")
# The device ms of the attention kernels before their Hopper redesign,
# quoted from PERF.md (kernel table: NVIDIA H100 80GB HBM3 at 700 W) by
# phase-10 label, for the log only: the kernels line carries this run's
# numbers alone
BEFORE_MS = {"flash f32 B8 S=T1024 H32/8": 8.977,
             "flash bf16 B8 S=T1024 H32/8": 9.100,
             "decode f32 B8 H32/8 T1088": 0.0822,
             "decode bf16 B8 H32/8 T1088": 0.0794}
GEMMA_FLASH = "flash bf16 B2 S=T4096 H32/16 window1024"
GEMMA_DECODE = "decode bf16 B8 H32/16 T4096"
# (atol, rtol) of (decode, flash) by input dtype: f32 as the reference's
# test; bf16 from the measured errors with room on both sides (decode's
# output is f32, about 3e-4 off; flash's is bf16, one ulp off), well under
# the reference's 2e-2 / 3e-2, which a wrong scale would pass
ATT_TOL = {torch.float32: ((2e-5, 2e-5), (2e-4, 2e-4)),
           torch.bfloat16: ((2e-3, 2e-3), (4e-3, 1e-2))}


def att_tol(name: str, dtype: torch.dtype) -> tuple:
    return ATT_TOL[dtype][0 if name == "decode_attention" else 1]


def att_close(got, want, tol: tuple, ctx: str) -> float:
    """Kernel output vs plain output within ``tol`` = (atol, rtol), as
    ``assert_allclose``; returns the max abs error."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{ctx}: output {tuple(got.shape)} not finite or not of the "
             f"plain version's shape {tuple(want.shape)}")
    err = (got - want).abs()
    atol, rtol = tol
    if not bool((err <= atol + rtol * want.abs()).all()):
        fail(f"{ctx}: differs from the plain version by up to "
             f"{float(err.max())} (atol {atol}, rtol {rtol})")
    return float(err.max())


def attended_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks let through, per (batch, head)."""
    i = torch.arange(s)[:, None]
    j = torch.arange(t)[None, :]
    mask = (j <= i) if causal else torch.ones((s, t), dtype=torch.bool)
    if window:
        mask = mask & (i - j < window)
    return int(mask.sum())


def attention_bound(name: str, args, kwargs) -> tuple:
    """Least time for one call: the bytes the function must move (q, the
    keys and values it attends to, the mask and the output, each once)
    over the memory rate, against its FLOPs (2 a multiply-add of QK^T and
    of PV over the pairs the masks let through) over the card's peak for
    the input type: f32 on the CUDA cores, bf16 on the tensor cores."""
    q = args[0]
    es = q.element_size()
    if name == "flash_attention":
        _, k, v = args
        b, s, h, hd = q.shape
        t, hdv = k.shape[1], v.shape[3]
        pairs = b * h * attended_pairs(s, t, kwargs.get("causal", True),
                                       kwargs.get("window", 0))
        n_bytes = (q.numel() + k.numel() + v.numel() + b * s * h * hdv) * es
        flops = 2 * pairs * (hd + hdv)
    else:
        _, k, v, valid = args
        b, h, hd = q.shape
        kvh = k.shape[2]
        n_valid = int(valid.sum())
        n_bytes = ((q.numel() + 2 * n_valid * kvh * hd) * es + valid.numel()
                   + b * h * hd * 4)
        flops = 4 * n_valid * h * hd
    peak = PEAK_BF16_PER_S if q.dtype == torch.bfloat16 else PEAK_OPS_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(name: str, args, kwargs):
    """One ``torch.nn.functional.scaled_dot_product_attention`` call on
    the same inputs (heads moved to dim 1 beforehand), timed as the
    library's time and never called by the port; None for a soft cap,
    which SDPA does not take."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if name == "decode_attention":
        q, k, v, valid = args
        qt = q[:, :, None].contiguous()
        kt, vt = (a.transpose(1, 2).contiguous() for a in (k, v))
        mask = valid[:, None, None, :]
        return lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    if kwargs.get("softcap"):
        return None
    q, k, v = (a.transpose(1, 2).contiguous() for a in args)
    s, t = q.shape[2], k.shape[2]
    causal, window = kwargs.get("causal", True), kwargs.get("window", 0)
    if window or (causal and s != t):
        i = torch.arange(s, device=q.device)[:, None]
        j = torch.arange(t, device=q.device)[None, :]
        mask = (j <= i) if causal else torch.ones_like(i - j, dtype=bool)
        if window:
            mask = mask & (i - j < window)
        return lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
    return lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)


def att_randn(rng, shape, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        dev, dtype)


def phase_attention_kernels(env: Env, dev) -> dict:
    """Phase 10: both attention kernels against their plain versions at
    the serving shapes and the reference test's variants, in f32 and
    bf16; the two large shapes timed with their bounds and SDPA's time."""
    att = env.att
    rng = np.random.default_rng(0)
    cases = []                      # (wrapper, label, args, kwargs, timed)
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        valid = torch.from_numpy(rng.random((8, 1088)) < 0.9).to(dev)
        valid[3] = False                        # a row with no valid key
        cases.append(("decode_attention", f"decode {tag} B8 H32/8 T1088",
                      (att_randn(rng, (8, 32, 128), dt, dev),
                       att_randn(rng, (8, 1088, 8, 128), dt, dev),
                       att_randn(rng, (8, 1088, 8, 128), dt, dev), valid),
                      {}, True))
        cases.append(("flash_attention", f"flash {tag} B8 S=T1024 H32/8",
                      tuple(att_randn(rng, s, dt, dev) for s in
                            ((8, 1024, 32, 128), (8, 1024, 8, 128),
                             (8, 1024, 8, 128))),
                      {"causal": True}, True))
    # gemma3-27b (configs/gemma3_27b.py: bf16, 32/16 heads of 128, local
    # window 1024): a local layer's prefill and a decode step over 4096
    valid = torch.from_numpy(rng.random((8, 4096)) < 0.9).to(dev)
    cases.append(("decode_attention", GEMMA_DECODE,
                  (att_randn(rng, (8, 32, 128), torch.bfloat16, dev),
                   att_randn(rng, (8, 4096, 16, 128), torch.bfloat16, dev),
                   att_randn(rng, (8, 4096, 16, 128), torch.bfloat16, dev),
                   valid), {}, True))
    cases.append(("flash_attention", GEMMA_FLASH,
                  tuple(att_randn(rng, s, torch.bfloat16, dev) for s in
                        ((2, 4096, 32, 128), (2, 4096, 16, 128),
                         (2, 4096, 16, 128))),
                  {"causal": True, "window": 1024}, True))
    for b, h, kvh, hd, t in ((2, 8, 8, 64, 1024), (2, 8, 2, 64, 1024),
                             (1, 16, 4, 128, 2048)):
        valid = torch.from_numpy(rng.random((b, t)) < 0.9).to(dev)
        cases.append(("decode_attention", f"decode ({b}, {h}/{kvh}, {hd}, "
                      f"{t})", tuple(att_randn(rng, s, torch.float32, dev)
                                     for s in ((b, h, hd), (b, t, kvh, hd),
                                               (b, t, kvh, hd))) + (valid,),
                      {}, False))
    for b, s, t, h, kv, hd, hdv, causal, window, cap in (
            (2, 256, 256, 4, 2, 64, 64, True, 0, 0.0),
            (1, 200, 200, 4, 4, 32, 32, True, 0, 50.0),
            (2, 128, 384, 2, 1, 64, 32, False, 0, 0.0),
            (1, 256, 256, 8, 2, 64, 64, True, 96, 0.0)):
        cases.append(("flash_attention", f"flash ({b}, {s}, {t}, {h}/{kv}, "
                      f"{hd}/{hdv}, causal={int(causal)}, window={window}, "
                      f"softcap={cap})",
                      tuple(att_randn(rng, sh, torch.float32, dev) for sh in
                            ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hdv))),
                      {"causal": causal, "window": window, "softcap": cap},
                      False))
    out = {"err": dict.fromkeys(ATT_WRAPPERS, 0.0), "large": {}}
    for name, label, args, kw, timed in cases:
        kernel = getattr(att, name)
        plain = getattr(att, name + "_plain")
        err = att_close(kernel(*args, **kw), plain(*args, **kw),
                        att_tol(name, args[0].dtype), label)
        out["err"][name] = max(out["err"][name], err)
        if timed:
            out["large"][label] = dict(
                wrapper=name, err=err, shape=[list(a.shape) for a in args],
                dtype=str(args[0].dtype).replace("torch.", ""),
                **times(lambda: kernel(*args, **kw),
                        lambda: plain(*args, **kw), 20,
                        1 if label == GEMMA_FLASH else 3,
                        library=sdpa_call(name, args, kw)),
                bound=attention_bound(name, args, kw))
    torch.cuda.empty_cache()
    kv_mb = {k: 2 * v["shape"][1][0] * v["shape"][1][1] * v["shape"][1][2]
             * v["shape"][1][3] * (2 if v["dtype"] == "bfloat16" else 4)
             / 1e6 for k, v in out["large"].items()
             if v["wrapper"] == "decode_attention"}
    tols = "; ".join(f"{str(dt)[6:]} (atol, rtol) decode {d}, flash {f}"
                     for dt, (d, f) in ATT_TOL.items())
    log(f"phase 10: attention kernels == plain within {tols} on "
        f"{len(cases)} cases (max abs err {json.dumps(out['err'])}); "
        + "; ".join(
            f"{k}: {v['ms']:.4f} ms on the card, plain {v['plain_ms']:.4f} "
            f"ms, SDPA {v['library_ms']:.4f} ms, bound "
            f"{v['bound'][0]:.4f} ms ({v['bound'][1]})"
            for k, v in out["large"].items())
        + "; decode K/V bytes " + ", ".join(
            f"{k}: {mb:.1f} MB ({'within' if mb < 50 else 'past'} the 50 "
            f"MB L2, so graph replay reads it from "
            f"{'L2' if mb < 50 else 'device memory'})"
            for k, mb in kv_mb.items()))
    log("phase 10: before the Hopper redesign, quoted from PERF.md and not "
        "measured in this run: " + "; ".join(
            f"{k}: {ms} ms" for k, ms in BEFORE_MS.items()))
    return out


# ------------------------------------------------------------ golden LM

def golden_lm_config(env: Env, cell: dict):
    cfg = env.configs.get(cell["arch"])
    return dataclasses.replace(cfg, name=f"{cfg.name}-{cell['num_layers']}l",
                               num_layers=cell["num_layers"])


def check_golden_rows(rows: np.ndarray, want: list) -> float:
    """``tests/test_torch_golden_lm.py``'s check: top logits within 1e-3 x
    max |logit| of the row, well-separated ranks in the reference's order,
    greedy token, sum and sum of squares; returns the max abs error."""
    worst = 0.0
    for i, (r, w) in enumerate(zip(rows, want)):
        tol = 1e-3 * w["max_abs"]
        idx, ref = np.asarray(w["top_idx"]), np.asarray(w["top_val"])
        err = np.abs(r[idx] - ref)
        worst = max(worst, float(err.max()))
        if not (err <= tol).all():
            fail(f"golden LM row {i}: logits off by {err.max()} > {tol}")
        order = np.argsort(-r, kind="stable")[:len(idx)]
        gaps = -np.diff(ref)
        for k in range(len(idx) - 1):
            lo = gaps[k - 1] if k else np.inf
            if lo > tol and gaps[k] > tol and order[k] != idx[k]:
                fail(f"golden LM row {i}: rank {k} is {order[k]}, "
                     f"reference {idx[k]}")
        if gaps[0] > tol and int(np.argmax(r)) != w["greedy"]:
            fail(f"golden LM row {i}: greedy {int(np.argmax(r))} != "
                 f"{w['greedy']}")
        r64 = r.astype(np.float64)
        if abs(r64.sum() - w["sum"]) > tol or \
                abs((r64 ** 2).sum() - w["sumsq"]) > 1e-3 * w["sumsq"]:
            fail(f"golden LM row {i}: sum or sum of squares off")
    return worst


def phase_golden_lm(env: Env, dev) -> dict:
    """Phase 11: the LM on the card (both attention kernels) replays the
    reference's golden logits at qwen3-4b's full width, 2 layers."""
    golden = json.loads(GOLDEN_LM.read_text())
    cell = golden["cell"]
    cfg = golden_lm_config(env, cell)
    t0 = time.perf_counter()
    model = env.models.LM(cfg, device=dev)
    env.models.params_from_numpy(
        model, env.models.seeded_numpy_params(cfg, cell["seed"]))
    rng = np.random.default_rng(cell["input_seed"])
    prompts = rng.integers(0, cfg.vocab_size, (cell["batch"], cell["prompt"]))
    teacher = rng.integers(0, cfg.vocab_size, (cell["steps"], cell["batch"]))
    caches = model.init_caches(cell["batch"], cell["prompt"] + cell["steps"])
    logits, caches = model.prefill(
        {"tokens": torch.from_numpy(prompts.astype(np.int32)).to(dev)},
        caches)
    rows = [logits]
    for t, tok in enumerate(teacher):
        logits, caches = model.decode_step(
            torch.from_numpy(tok.astype(np.int32)).to(dev), caches,
            cell["prompt"] + t)
        rows.append(logits)
    rows = torch.cat(rows).float().cpu().numpy()
    if rows.shape != (len(golden["rows"]), cfg.padded_vocab()) or \
            not np.isfinite(rows).all():
        fail(f"golden LM: logits {rows.shape} not finite or not of the "
             f"golden's shape")
    err = check_golden_rows(rows, golden["rows"])
    log(f"phase 11: golden LM ({cfg.name}, {cfg.param_count()[0]} "
        f"parameters) on the card matches the reference's logits: "
        f"{len(rows)} rows, max abs err {err:.3g} on the stored top-"
        f"{cell['top']}, {time.perf_counter() - t0:.1f} s")
    del model, caches
    torch.cuda.empty_cache()
    return {"err": err, "rows": len(rows)}


# ------------------------------------------------ serving at full width

SERVE_ARCH = "qwen3-4b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_SHARED = 8, 1024, 32, 512


class StepTimer:
    """While entered, times ``model.prefill`` and ``model.decode_step``
    (host clock around each call, synchronised before and after: the
    engine reads the result back right after each anyway)."""

    def __init__(self, model):
        self.model = model
        self.prefill_s = self.decode_s = 0.0
        self.prefills = self.steps = 0

    def _wrap(self, fn, kind):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if kind == "prefill":
                self.prefill_s += dt
                self.prefills += 1
            else:
                self.decode_s += dt
                self.steps += 1
            return out
        return call

    def __enter__(self):
        m = self.model
        m.prefill = self._wrap(type(m).prefill.__get__(m), "prefill")
        m.decode_step = self._wrap(type(m).decode_step.__get__(m), "decode")
        return self

    def __exit__(self, *exc):
        del self.model.prefill, self.model.decode_step

    def reset(self):
        self.prefill_s = self.decode_s = 0.0
        self.prefills = self.steps = 0


def phase_serving(env: Env, dev) -> dict:
    """Phase 12: qwen3-4b at full width and depth served by the port's
    ``Engine`` through both attention kernels; the main path of the
    attention kernels, whose launches the kernels line reports."""
    att, kp, se = env.att, env.pool, env.serving
    cfg = env.configs.get(SERVE_ARCH)
    t0 = time.perf_counter()
    model = env.models.LM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    if len(model.layers) != 36 or cfg.d_model != 2560 or \
            model.dtype != torch.float32:
        fail(f"serving: not qwen3-4b at full width and depth ({cfg})")
    max_len = SERVE_PROMPT + SERVE_NEW + 32
    rng = np.random.default_rng(0)
    r1 = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))
    r3 = r1.copy()
    r3[:, SERVE_SHARED:] = rng.integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT - SERVE_SHARED))
    eng = se.Engine(model, max_len=max_len)
    off = se.Engine(model, max_len=max_len, morpheus=False)
    rounds = [("cold", eng, r1), ("warm", eng, r1),
              ("shared prefix", eng, r3), ("morpheus off", off, r1)]
    results = []
    with StepTimer(model) as timer, PathCalls(env.ops, ATT_WRAPPERS) as calls:
        torch.cuda.synchronize()
        att.reset_launches()
        kp.reset_launches()
        for name, e, prompts in rounds:
            reqs = [se.Request(i, p.tolist(), SERVE_NEW)
                    for i, p in enumerate(prompts)]
            before = (e.pages_reused, e.pages_fetched)
            timer.reset()
            t0 = time.perf_counter()
            rep = e.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            results.append(dict(
                round=name, wall_s=wall, prefill_s=timer.prefill_s,
                decode_ms_step=1e3 * timer.decode_s / max(timer.steps, 1),
                steps=rep.steps, generated=rep.generated,
                tokens_per_s=rep.generated / wall,
                pool_s=wall - timer.prefill_s - timer.decode_s,
                pages_reused=e.pages_reused - before[0],
                pages_fetched=e.pages_fetched - before[1],
                hit_rate=rep.page_hit_rate, pred_miss=rep.pred_miss,
                false_pos=rep.false_pos, modeled_time_ns=rep.modeled_time_ns,
                tokens=[r.out_tokens for r in reqs]))
        torch.cuda.synchronize()
        counts, plain = dict(att.launches), dict(att.plain_runs)
        pool_counts, pool_plain = dict(kp.launches), dict(kp.plain_runs)
    steps = sum(r["steps"] for r in results)
    n_layers = len(model.layers)
    want = {"flash_attention": n_layers * len(rounds),
            "decode_attention": n_layers * steps}
    if counts != want:
        fail(f"serving: attention launches {counts}, expected {want}")
    if any(plain.values()) or any(pool_plain.values()):
        fail(f"serving: plain versions ran ({plain}, {pool_plain})")
    if not pool_counts["lookup_fill"] or pool_counts["tag_lookup"]:
        fail(f"serving: the pool's conventional tier launched lookup_fill "
             f"{pool_counts['lookup_fill']} and tag_lookup "
             f"{pool_counts['tag_lookup']} times")
    tok = {r["round"]: r["tokens"] for r in results}
    vocab = cfg.padded_vocab()
    for r in results:
        if any(len(t) != SERVE_NEW or min(t) < 0 or max(t) >= vocab
               for t in r["tokens"]):
            fail(f"serving round {r['round']}: tokens out of range or short")
    if tok["morpheus off"] != tok["cold"]:
        fail("serving: tokens differ with Morpheus off")
    if tok["warm"] != tok["cold"]:
        fail("serving: the same prompts gave other tokens on a second run")
    cold, warm, shared = results[:3]
    if cold["pages_fetched"] != SERVE_BATCH * SERVE_PROMPT // 16 or \
            warm["pages_reused"] == 0 or shared["pages_reused"] == 0:
        fail(f"serving: page accounting off ({results[:3]})")

    # one profiled prefill and decode step, after the counted run
    caches = model.init_caches(SERVE_BATCH, max_len)
    toks = torch.from_numpy(r1.astype(np.int32)).to(dev)
    box = {}
    pre_w = profiled_window(lambda: box.update(
        out=model.prefill({"tokens": toks}, caches)), ATT_KERNELS)
    cur = box["out"][0].argmax(-1).to(torch.int32)
    dec_w = profiled_window(
        lambda: model.decode_step(cur, caches, SERVE_PROMPT), ATT_KERNELS)
    del caches, box
    kv_bytes = (n_layers * SERVE_BATCH * (SERVE_PROMPT + SERVE_NEW)
                * cfg.num_kv_heads * cfg.resolved_head_dim * 4 * 2)
    bound_w = weight_bytes / HBM_BYTES_PER_S * 1e3
    bound_kv = (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"phase 12: serving {cfg.name}: {len(model.layers)} layers, d_model "
        f"{cfg.d_model}, {n_params} parameters ({weight_bytes / 1e9:.2f} GB "
        f"float32, drawn on the card in {init_s:.2f} s), batch "
        f"{SERVE_BATCH} x {SERVE_PROMPT}-token prompts, {SERVE_NEW} new "
        f"tokens; " + "; ".join(
            f"{r['round']}: {r['wall_s']:.3f} s, prefill "
            f"{r['prefill_s']:.3f} s, decode {r['decode_ms_step']:.3f} ms a "
            f"step x {r['steps']}, pool and host {r['pool_s']:.3f} s, "
            f"{r['tokens_per_s']:.1f} tokens/s, pages reused "
            f"{r['pages_reused']} fetched {r['pages_fetched']}, hit rate "
            f"{r['hit_rate']:.4f}, predicted misses {r['pred_miss']}, false "
            f"positives {r['false_pos']}" for r in results)
        + f"; Morpheus off gave the same tokens; attention launches "
        f"{json.dumps(counts)}, pool launches {json.dumps(pool_counts)}, "
        f"plain runs 0; pool stats {json.dumps(eng.pool.stats._asdict())}; "
        f"decode step bytes bound {bound_w:.3f} ms (weights) / "
        f"{bound_kv:.3f} ms (weights + KV at the last step) at 3.35 TB/s; "
        + window_text(pre_w, "one prefill", "the attention kernels") + "; "
        + window_text(dec_w, "one decode step", "the attention kernels"))
    for r in results:
        del r["tokens"]
    del model, eng, off
    torch.cuda.empty_cache()
    return {"launches": counts, "pool_launches": pool_counts,
            "rounds": results, "calls": calls, "init_s": init_s,
            "params": n_params, "bound_ms": [bound_w, bound_kv],
            "prefill_window": pre_w, "decode_window": dec_w}


def phase_attention_path(env: Env, calls: PathCalls) -> dict:
    """Phase 13: every attention call of the serving phase, one per input
    shape, against its plain version, timed with its bound and SDPA's
    time."""
    att = env.att
    out = {}
    for key, args in calls.inputs.items():
        name, shapes, kw = key
        kwargs = dict(kw)
        kernel = getattr(att, name)
        plain = getattr(att, name + "_plain")
        err = att_close(kernel(*args, **kwargs), plain(*args, **kwargs),
                        att_tol(name, args[0].dtype),
                        f"serving path {name} {shapes}")
        out.setdefault(name, []).append(dict(
            shape=[list(s) for s in shapes], kwargs=kwargs,
            dtype=str(args[0].dtype).replace("torch.", ""),
            launches=calls.calls[key], err=err,
            **times(lambda: kernel(*args, **kwargs),
                    lambda: plain(*args, **kwargs), 20, 3,
                    library=sdpa_call(name, args, kwargs)),
            bound=attention_bound(name, args, kwargs)))
    for name in ATT_WRAPPERS:
        if name not in out:
            fail(f"serving path: {name} was never called")
    log("phase 13: attention kernels == plain at the serving path's shapes: "
        + "; ".join(
            f"{name} {t['shape']} x{t['launches']}: {t['ms']:.4f} ms on the "
            f"card ({t['call_ms']:.4f} ms a call), plain {t['plain_ms']:.4f} "
            f"ms, SDPA {t['library_ms']:.4f} ms, bound {t['bound'][0]:.4f} "
            f"ms ({t['bound'][1]}), max abs err {t['err']:.3g}"
            for name, rows in out.items() for t in rows))
    return out


def attention_kernel_rows(ak: dict, serving: dict, path: dict,
                          golden_err: float, ptxas: dict) -> list:
    """The attention kernels' entries of the kernels line: launches of the
    serving phase, times at the path's most frequent shape, and the
    large shapes of phase 10."""
    src = "src/repro_torch/kernels/csrc/attention.cu"
    rows = {"decode_attention": ("src/repro/kernels/decode_attn.py:26",
                                 "decode_partial_kernel<T, GB, Cfg> (CUDA "
                                 "cores) or decode_partial_kernel_tc (bf16, "
                                 "mma.sync) + decode_combine_kernel"),
            "flash_attention": ("src/repro/kernels/flash_attn.py:47",
                                "flash_kernel_f32<D> (f32, CUDA cores), "
                                "flash_kernel_bf16<D> (bf16, "
                                "wgmma.mma_async)")}
    out = []
    for name, (replaces, kernel) in rows.items():
        head = max(path[name], key=lambda t: t["launches"])
        large = {k: {f: v[f] for f in ("shape", "dtype", "ms", "call_ms",
                                       "plain_ms", "library_ms")}
                 | {"bound_ms": v["bound"][0], "bound_by": v["bound"][1]}
                 for k, v in ak["large"].items() if v["wrapper"] == name}
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "kernel": kernel,
            "launches": serving["launches"][name],
            "max_abs_err": max([ak["err"][name]]
                               + [t["err"] for t in path[name]]),
            "golden_lm_max_abs_err": golden_err,
            "ms": head["ms"], "call_ms": head["call_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound"][0],
            "bound_by": head["bound"][1], "library_ms": head["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention",
            "shape": head["shape"], "dtype": head["dtype"],
            "ptxas": {k: v for k, v in ptxas.items()
                      if k.startswith(name.split("_")[0])},
            "large": large})
    return out


def pool_kernel_rows(pk: dict, cells: dict, paths: dict) -> list:
    """The pool kernels' entries of the kernels line: launches and times
    at the shape the engine-traffic cell (the main path) launched most,
    the other shapes timed on the path, and the large shapes of phase 5
    (``large``, and ``large_<entry>`` for the path's wrapper where phase 5
    times it apart from the reference signature)."""
    src = "src/repro_torch/kernels/csrc/pool.cu"
    rows = {  # name: (replaces, kernel, wrappers, more phase-5 entries)
        "tag_lookup": ("src/repro/kernels/tag_lookup.py:26",
                       "lookup_fill_kernel", ("lookup_fill", "tag_lookup"),
                       ("lookup_fill",)),
        "bloom_query": ("src/repro/kernels/bloom_query.py:33",
                        "bloom_query_kernel", ("bloom_query",),
                        ("bloom_query_rows",)),
        "bloom_record": ("src/repro/kernels/bloom_query.py:33",
                         "bloom_record_kernel", ("bloom_record",), ()),
        "bdi_compress": ("src/repro/kernels/bdi.py:28",
                         "page_write_kernel", ("page_write", "bdi_compress"),
                         ("page_write",)),
        "bdi_decompress": ("src/repro/kernels/bdi.py:45",
                           "block_read_kernel",
                           ("read_rows", "bdi_decompress"), ("read_rows",)),
        "gather_blocks": ("src/repro/kernels/gather_blocks.py:26",
                          "block_read_kernel",
                          ("read_rows", "gather_blocks", "cached_block_read"),
                          ("read_rows",)),
    }
    notes = {"tag_lookup": "on the serving path the pool's conventional tier "
             "(the reference's round loop of tag_lookup and _conv_fill, "
             "src/repro/serving/paged_kv.py:221-253, 353) runs as one "
             "lookup_fill launch a batch; tag_lookup is the same kernel, one "
             "round",
             "bdi_compress": "on the serving path write_page (the reference's "
             "_probe, bdi_compress and three .at[].set, "
             "src/repro/serving/paged_kv.py:293-313) runs as one page_write "
             "launch; bdi_compress is the same kernel without the probe",
             "bloom_record": "the reference pool's per-key _bloom_record "
             "(src/repro/serving/paged_kv.py:390: two _query_kernel "
             "launches and two ORs a key) as one launch a batch",
             "bdi_decompress": "on the serving path the decompression runs "
             "fused into read_rows' extended-tier rows; the path's numbers "
             "are read_rows'",
             "gather_blocks": "on the serving path read_rows reads both "
             "tiers in one launch; cached_block_read (gather + decompress) "
             "is the same kernel with per-row level/base"}
    out = []
    for name, (replaces, kernel, wrappers, more) in rows.items():
        head = paths["engine"][wrappers[0]]["timed"][0]
        timed = [dict(wrapper=w, **{k: v for k, v in t.items()
                                    if k != "bound"},
                      bound_ms=t["bound"][0], bound_by=t["bound"][1])
                 for c in paths for w in wrappers if w in paths[c]
                 for t in paths[c][w]["timed"]]
        large = {k: {"shape": pk[k]["shape"], "ms": pk[k]["ms"],
                     "call_ms": pk[k]["call_ms"],
                     "plain_ms": pk[k]["plain_ms"],
                     "bound_ms": pk[k]["bound"][0],
                     "library_ms": pk[k]["library_ms"]}
                 for k in (name, *more)}
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "kernel": kernel,
            "launches": sum(cells["engine"]["launches"][w]
                            for w in wrappers),
            "launches_by_wrapper": {c: {w: cells[c]["launches"][w]
                                        for w in wrappers} for c in cells},
            "max_abs_err": max([pk[k]["err"] for k in large] + [
                paths[c][w]["err"] for c in paths for w in wrappers
                if w in paths[c]]),
            "ms": head["ms"], "call_ms": head["call_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound"][0],
            "bound_by": head["bound"][1], "library_ms": head["library_ms"],
            "shape": head["shape"], "path_shapes": timed,
            "launch_floor_ms": pk["launch_floor_ms"],
            "large": large.pop(name),
            **{f"large_{k}": v for k, v in large.items()},
            **({"note": notes[name]} if name in notes else {})})
    return out


def ptxas_summary(log_text: str) -> dict:
    """Registers and spill bytes of each kernel of a ``-Xptxas -v``
    report, by readable name (``flash_kernel_f32<128>``,
    ``decode_partial_kernel<bf16, 2, 128, 32, 3>``, ``ext_scan_kernel<4>``,
    ``conv_scan_kernel``)."""
    import re
    out, cur = {}, None
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"(flash_kernel_f32|flash_kernel_bf16|"
                          r"decode_partial_kernel_tc|decode_partial_kernel|"
                          r"decode_combine_kernel|conv_scan_kernel|"
                          r"ext_scan_kernel)"
                          r"(?:(I.*?)?E[vP]|(?=ENS))", m.group(1))
            if k is None:
                cur = None
                continue
            args = [("bf16" if a == "13__nv_bfloat16" else
                     "float" if a == "If" else a.strip("LiE"))
                    for a in re.findall(r"13__nv_bfloat16|If|Li\d+E",
                                        k.group(2) or "")]
            cur = k.group(1) + (f"<{', '.join(args)}>" if args else "")
            out[cur] = {"registers": None, "spill_stores": 0,
                        "spill_loads": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False      # full f32 products
    torch.set_float32_matmul_precision("highest")
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        fail("float32 matmuls are not in full precision")
    log(f"phase 1: card {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; matmul allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}, float32 matmul precision "
        f"{torch.get_float32_matmul_precision()!r}")
    env = Env()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as ex:     # one nvcc per source
        list(ex.map(env.build.build, SOURCES))
    log(f"phase 1: built {', '.join(SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        report = [ln.strip() for ln in env.build.build_log(name).splitlines()
                  if ("registers" in ln or "spill" in ln
                      or "Compiling entry" in ln) and "(C7519)" not in ln]
        log(f"phase 1: ptxas {name}: {' | '.join(report)}")
    scan_ptxas = ptxas_summary(env.build.build_log("engine_scan"))
    att_ptxas = ptxas_summary(env.build.build_log("attention"))
    for what, summary in (("engine-scan", scan_ptxas),
                          ("attention", att_ptxas)):
        log(f"phase 1: {what} kernels (ptxas): " + "; ".join(
            f"{k}: {v['registers']} registers, {v['spill_stores']} B spill "
            f"stores, {v['spill_loads']} B spill loads"
            for k, v in summary.items()))

    k = phase_kernels(env, dev)
    phase_golden(env, dev)
    main_path = phase_main(env, dev)
    pk = phase_pool_kernels(env, dev)
    phase_golden_pool(env, dev)
    cells = {"engine": phase_engine_serving(env, dev),
             "full_scale": phase_full_scale(env, dev)}
    paths = phase_path_shapes(env, cells)
    ak = phase_attention_kernels(env, dev)
    golden_lm = phase_golden_lm(env, dev)
    serving = phase_serving(env, dev)
    att_path = phase_attention_path(env, serving["calls"])

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
            "ms": t["ms"], "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": None, "shape_BSL": t["shape"],
            "ways": t["ways"], "launch": t["launch"],
            "longest_set_active": t["longest_active"],
            "ns_per_request_slot": t["ns_per_slot"],
            "ptxas": {n: v for n, v in scan_ptxas.items()
                      if n.startswith(name.split("_")[0])},
        })
    kernels += pool_kernel_rows(pk, cells, paths)
    kernels += attention_kernel_rows(ak, serving, att_path, golden_lm["err"],
                                     att_ptxas)
    log("phase 14: kernels " + ", ".join(
        f"{x['name']} matched plain (max abs err {x['max_abs_err']:.3g}), "
        f"{x['ms']:.4g} ms on the card ({x['call_ms']:.4g} ms a call) vs "
        f"plain {x['plain_ms']:.4g} ms, bound {x['bound_ms']:.4g} ms "
        f"({x['bound_by']}), {x['launches']} launches" for x in kernels))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
