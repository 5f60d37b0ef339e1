#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the Morpheus simulator, its serving
page pool, its serving engine over every model family, its online
runtime, its fleet runtime, admission control and autotuner, its
training stack, its two launchers, its roofline analysis and its
multi-device paths (worlds of ranks sharing the card, tensor and
context parallelism) on one NVIDIA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero and prints no result):

  1. device and build: the card's name and power limit, the float32
     matmul settings (TF32 off, precision "highest"), then ``nvcc`` of
     the kernel sources of ``src/repro_torch/kernels/csrc`` (one process
     each, all started together) with their ``-Xptxas -v`` reports
     (registers, shared memory, spills), summed up per kernel for the
     engine-scan and attention kernels (the flash backward's may not
     spill);
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
  14. main path of the online runtime, at the full-profile cells of
     ``benchmarks/fig_online.py`` and ``benchmarks/fig_serving.py``
     (Morpheus-ALL on the 4-rung ladder (18, 32, 48, 68)): the stationary
     ``cfd`` cell (240 000 requests, epochs of 3 000), the phased
     ``("kmeans", "lib")`` cell (320 000), the two-tenant bursty cell
     (``cfd,kmeans`` under MMPP, 240 000, ``SERVING_GCFG``) and the
     stationary cell pinned at (48, 20), each through ``simulate_online``
     with the scans' counts set to 0 before and read after (one stateful
     ``conv_scan`` an epoch, one ``ext_scan`` an epoch whose split has
     cache cores, no plain version) and held to
     ``tests/data/torch_golden_online.json`` (decisions, splits and
     integer Stats identical, floats within 1e-3 relative, per-tenant
     Stats summing to the global ones); the stationary cell replayed to
     epoch 40 (``advance_packed`` by CUDA events, a profiled window of 5
     epochs), its state handed off to another split and the next epoch
     through both stateful scans against their plain versions on the
     same rows, timed; an ``EpochStream`` with ``ring=2`` against
     ``ring=0``, and a mid-run snapshot through ``save_state`` and
     ``load_state`` resumed to the uninterrupted run; ``ServingGovernor``
     ticking once a prompt over ``demo_pool`` under phase 7's traffic on
     the card and on the CPU, identical, with phase 7's launches a
     lookup; wall s, epochs/s, simulated requests/s and the host split
     (obs spans: trace generation, pack, advance, governor, handoffs);
  15. fleet, admission and autotune, at the reference figures' settings
     (``tests/data/torch_golden_fleet.json``): ``simulate_fleet`` of
     ``benchmarks/fig_fleet.py``'s full profile (64 replicas cycling
     cfd / stencil / p-bfs / kmeans, Morpheus-ALL, 48 000 requests,
     epochs of 3 000, seed i, each on its app's 4-rung ladder) with the
     scans' counts set to 0 before and read after (one stateful
     ``conv_scan`` a group epoch, one ``ext_scan`` a group epoch whose
     split has cache cores, no plain version), held to the reference's
     decisions, splits and integer Stats (floats within 1e-3), to
     ``run_serial`` on the card (1e-9 on ``ipc`` and rewards) and to the
     prefixes N = 1, 4, 16; wall s and replica-epochs/s of both; the 64
     replicas pinned at (18, 50) as one B = 64 group: the synchronising
     calls of a group epoch (CUDA sync debug mode), a profiled window of
     3 steps, the row contract's check and both stateful scans at B = 64
     against their plain versions with their bounds; the advisor
     ablation (a cold fleet of 4 teaches, a fresh wave runs cold and
     warm); ``simulate_overload`` of ``benchmarks/fig_overload.py``'s
     full profile at load 8 (base 128, 36 rounds, hi/mid/lo), SLOs from
     the port's own calibration run, with ``AdmissionConfig()`` and
     without, and the four scenario CRCs of ``tests/scenarios.py`` from
     the port's controller; ``Tuner`` at ``benchmarks/fig_autotune.py``'s
     quick budgets (``GovernorObjective`` GA 4 x 3 on the two quick
     cells, ``HardwareObjective("cfd")`` hill climb 5 x 4), each
     generation's configs identical to the reference's;
  16. every model family: the decode kernel with gemma2-9b's soft cap
     (B 4, H 16/8, hd 256, T 528, f32 and bf16) against its plain
     version, timed with its bound (SDPA takes no soft cap); each
     family served by ``Engine`` at full width with weights drawn on
     the card (CUDA generator, seed 0), the attention counts set to 0
     before and read after: mamba2-780m (48 layers) and
     seamless-m4t-medium (12 + 12) at full depth, deepseek-v2-lite-16b,
     deepseek-moe-16b, gemma2-9b and qwen2-vl-7b at depth 8, and
     jamba-1.5-large's ``reduced()`` config (its full width needs more
     than one card); 4 prompts of 512 random tokens and 16 new tokens,
     the same round again, then ``Engine(morpheus=False)``: the tokens of
     the three equal, each round's flash and decode launches the
     model's, no plain version; every attention call of that path, one
     per input shape, against its plain version, timed with its bound
     and SDPA's time where SDPA computes the same function; the six
     golden cells of ``tests/data/torch_golden_substrates.json`` (each
     family at full width, 2 decoder layers, weights
     ``seeded_numpy_params`` drawn by host threads meanwhile): logits
     rows, qwen2-vl's M-RoPE forward rows and each MoE call's routing
     (expert sets where the top-k margin exceeds 1e-4, drops per expert)
     held to the reference's;
  17. the flash backward (``csrc/attention_bwd.cu``: a dQ kernel, then a
     dK/dV kernel, reading the log-sum-exp the forward kept; bf16 on
     ``wgmma``, f32 register-tiled CUDA cores) against its plain version
     at the training shape (B 8, S = T 128, H 32/8, hd 128, f32), the
     serving shape (B 8, S = T 1024) in f32 and bf16, MLA's head dims
     (B 4, S = T 512, H 16, hd 192 / hdv 128), gemma2-9b's window 256
     and soft cap 50 (B 2, S = T 1024, H 16/8, hd 256) and a non-causal
     cross shape (S 256, T 384): the forward's log-sum-exp against
     ``torch.logsumexp`` of the plain logits (rows with a valid key),
     the forward's time with and without it, the backward's device ms by
     CUDA-graph replay and its two kernels' by ``torch.profiler``, its
     bound (2.5 times the forward's FLOPs) and the time of
     ``torch.autograd.grad`` through SDPA;
  18. main path of training: (a) the three cells of
     ``tests/data/torch_golden_train.json`` (qwen3-4b, gemma2-9b and
     deepseek-v2-lite-16b at full width, 2 decoder layers, the
     reference's batch): step-0 loss within 1e-4, ``grad_norm`` and each
     gradient leaf's norm and kept entries within 1e-3, the losses after
     AdamW steps 1 and 2 within 1e-3; (b) qwen3-4b at full width, 8
     layers (of 36, for memory), f32, through ``train.loop.train`` (batch 8
     x 128, the launcher's defaults) with the attention counts set to 0
     before and read after: 24 steps checkpointed at their end, resumed
     to 30 (a falling loss, ``resumed_from`` 24, no restart, two flash
     forwards and one backward a layer and step, no plain version), then
     4-step runs twice each, plain, with the int8 compressor and with 2
     microbatches, equal within 1e-5; ms a step, tokens/s, peak memory;
  19. the launchers: ``launch.serve.main`` on the card in six modes
     (static, ``--split 2``, ``--split auto``, ``--workload`` with
     ``--arrival``, ``--slo-ms``, ``--tenant-slo`` with ``--admission``),
     every printed line but the wall-clock fields equal to the same run
     on the CPU; ``launch.train.main`` of h2o-danube-1.8b for 12 steps;
  20. the roofline (``repro_torch.roofline``): (a) the one-device dry
     run (``launch.dryrun.lower_cell``, counted on ``meta``) of qwen3-4b's
     four cells, each with its bound, dominant term and whether it fits
     the card; (b) phase 12's 8 x 1024 prefill and one decode step on its
     own model (qwen3-4b at full width and depth) and (c) one training
     step of phase 18's config and batch, each counted by the op counter
     on the card (through the kernels) and on ``meta``, FLOPs and bytes
     equal, then set against its measured time (CUDA events and wall
     clock without the counter, phase 12's profiled device time, phase
     18's ms a step): the bound, the dominant term, the roofline fraction
     and the model-FLOPs share, each in (0, 1];
  21. more than one device (``distributed.world``, ``launch.mesh``,
     ``distributed.sharding``): (a) a world of one rank over NCCL in this
     process: the 64-replica fleet of phase 15 under ``make_fleet_mesh()``
     held to the golden file and to phase 15's run (1e-9),
     deepseek-moe-16b's MoE layer at full width (64 experts of 2048 x
     1408 and 2 shared, f32) on a (1, 1) mesh against the one-process
     layer, the qwen3-4b golden training cell (full width, 2 layers)
     through the train step with a (1, 1) mesh held to the golden bounds
     of phase 18, and ``train.loop.train`` of that config on (1, 1), 2
     steps with the supervisor's checkpoint and a resumption to 3, held to
     the same calls in one process without a mesh; (b) a gloo world of
     4 processes sharing the card
     (``world.spawn``; each checks that it imported neither ``jax`` nor
     ``repro``): the fleet on a fleet axis of 4 (each rank advancing 16
     rows of a B = 64 group) equal to the golden file on every rank, the
     MoE layer on (1, 4) and (2, 2) (each row within 1e-4 of its max,
     gradients within 1e-3), the golden training cell on (2, 1) (one row
     a rank), ``train.loop.train`` on (2, 1) as in (a), both ranks equal
     and held to the one-process run, and ``restore_on_mesh`` on (2, 2)
     of the checkpoint its supervisor wrote from rank 0 (each shard
     bit-identical to its block of the full leaf); the card's compute
     mode, each rank's
     launches, seconds and peak memory;
  22. tensor and context parallelism over DTensor
     (``distributed.tensor_parallel``): (a) the kernels' two options
     against their plain versions: the flash forward and backward with a
     query offset ``q_start`` on qwen2-vl-7b's context-parallel blocks
     (3 x 1024 rows against 3072 keys, 28/4 heads of 128, f32 and bf16),
     and ``decode_attention_with_lse`` on two halves of qwen3-4b's decode
     cache (B 8, 32/8 heads, T 4096, f32) merged against the whole call,
     each with its time, bound, SDPA's time and the call without the
     option; (b) a gloo world of 2 processes sharing the card, mesh
     (1, 2): qwen3-4b at full width and 8 layers placed by
     ``distribute_model`` (each leaf drawn from one generator, each rank
     keeping its shard), a 4 x 128 prefill, 8 greedy decode steps and one
     AdamW step on 4 x 128, held to the same calls in one process
     (tokens identical, logits 1e-4, loss 1e-5 relative); (c) a gloo
     world of 3, mesh (1, 3): qwen2-vl-7b at full width, 2 layers (28
     query heads on an axis of 3: context parallel, its 4 KV heads
     sequence-sharded), a prefill of 3072 tokens, 6 decode steps and one
     loss with its gradients, held alike; every rank launches flash,
     decode and backward (the ranks past 0 with ``q_start``) and runs no
     plain version; each rank's times and peak memory;
  23. the entry scripts' twins, loaded by path and run on the card with
     every launch count from 0: (a) ``examples/torch_morpheus_replay.py``
     for kmeans and cfd at its default 30 000 requests, every row (best
     split, integer Stats, normalized time, hit rate, MPKI; the
     predictor ablation) against the reference's golden
     (``tests/data/torch_golden_examples.json``: splits and Stats
     identical, floats within 1e-3); (b) ``examples/torch_quickstart.py``:
     the pool's stats against the golden, the reduced qwen3-4b forward
     and AdamW step, the simulator's BL and Morpheus-ALL runs against the
     golden; (c) ``examples/torch_serve_morpheus.py``'s ``run`` with
     qwen3-4b at full width (depth cut to 4), batch 4, prompt 32, +8,
     ``--split auto`` for 6 rounds: tokens/s, the governor's decisions,
     tokens identical with the pool on and off; (d)
     ``examples/torch_train_lm.py --model-100m``: 60 steps with
     checkpoints and the restart, ms a step; (e) ``tools/
     torch_profile_cell.py engine cfd:Morpheus-ALL:32:36``, which must
     list both scan kernels' device ms; both scans, the pool's
     ``lookup_fill``, ``bloom_query``, ``bloom_record`` and ``page_write``
     (no script reads a page back), flash forward and backward and decode
     launched, no plain version run.  Phase 22 (c) also runs
     deepseek-moe-16b's MoE layer at full width on (1, 3) (64 experts on
     an axis of 3: the dense fallback) against the one-process layer;
  24. the bf16 path, gemma3-27b as published (bf16; weights drawn on the
     card, or for the golden cells by host threads meanwhile): (a) the
     two cells of ``tests/data/torch_golden_bf16.json`` (full width, 2
     and 8 layers, the second a prompt of 1040 tokens past the local
     layers' 1024-row ring), each phase's logits held to the reference's
     f32 oracle no further than 2 x the reference's bf16 run plus 1e-3 x
     max |logit|, greedy tokens equal where the oracle's top-2 margin
     exceeds 4 x the larger error; (b) all 62 layers (54.0 GB) served by
     ``Engine``, 4 prompts of 2048 random tokens and 16 new, the same
     round again, then ``Engine(morpheus=False)``: the tokens of the
     three equal, each round's flash and decode launches the model's, all
     of them on ``flash_kernel_bf16`` and ``decode_partial_kernel_tc``,
     no plain version; layers 0, 7 and 61 of the first prefill against
     their f32 twins on the card at the inputs the run gave them (within
     2 x the reference's one-layer error of golden cell B plus 1e-3);
     every attention call of the path against its plain version; prefill
     s, decode ms a step, tokens/s, peak memory, the prefill's MFU
     against ``roofline.op_cost``'s count at 989 TFLOP/s, the decode
     step's share of its weights' bytes bound; (c) ``train.loop.train``
     at 8 layers (4.71 B parameters, bf16 weights and gradients, f32
     moments), batch 8 x 128, 8 steps, every flash forward and backward
     on the bf16 kernels, then 2 layers (golden cell A's weights, the
     reference's batch) for 3 AdamW steps in bf16, in f32 and in f32 with
     the weights rounded to bf16 after each update: step 0's bf16 loss
     against f32's and every step's against the bf16-storage run's within
     2 x the CPU reference's step-0 bf16 loss error plus 1e-4; the bf16
     backward at that shape against its plain version; ms a step,
     tokens/s, MFU, peak memory;
  25. the ported kernels with their launches (phase 4 for the engine
     scans, phases 14, 15 and 21 for their stateful twins, phase 7 for
     the pool, phases 12, 16, 18, 21 and 24 for attention, phases 18, 21
     and 24 for the flash backward, phase 22 for the options; each row's
     launches in phase 23 beside them, and phase 24's on the bf16
     tensor-core kernels), errors, times and bounds (every
     bound from ``repro_torch.roofline.kernel_work``, the count the
     wrappers charge the op counter).

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
GOLDEN_ONLINE = ROOT / "tests" / "data" / "torch_golden_online.json"
GOLDEN_FLEET = ROOT / "tests" / "data" / "torch_golden_fleet.json"
GOLDEN_TRAIN = ROOT / "tests" / "data" / "torch_golden_train.json"
SOURCES = ("engine_scan", "pool", "attention", "attention_bwd")

# The device ms of the engine-scan kernels at phase 2's timed shape before
# their Hopper redesign, quoted from PERF.md (kernel table: NVIDIA H100
# 80GB HBM3 at 700 W), for the log only
SCAN_BEFORE_MS = {"conv_scan": "0.0527", "ext_scan": "1.746-1.761"}
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
        from repro_torch import autotune, obs
        from repro_torch.runtime import admission, fleet, governor, stream
        from repro_torch.workloads import overload
        from repro_torch.workloads import serving as serv
        from repro_torch.workloads.serving import bursty_workload
        from repro_torch.core import cache_sim, controller, engine, policy
        from repro_torch.kernels import (_build, attention, engine_scan, ops,
                                         pool)
        from repro_torch.serving import engine as serving_engine
        from repro_torch.serving import paged_kv
        from repro_torch import data, optim, pytree
        from repro_torch.launch import serve as launch_serve
        from repro_torch.launch import train as launch_train
        from repro_torch.train import loop as train_loop
        from repro_torch.train import train_step
        from repro_torch import checkpoint
        from repro_torch.distributed import context, sharding, world
        from repro_torch.distributed import tensor_parallel
        from repro_torch.launch import mesh
        self.tp = tensor_parallel
        self.checkpoint = checkpoint
        self.context, self.sharding, self.world = context, sharding, world
        self.mesh = mesh
        self.data, self.optim, self.pytree = data, optim, pytree
        self.train_loop, self.train_step = train_loop, train_step
        self.launch_serve, self.launch_train = launch_serve, launch_train
        self.cs, self.ctl, self.engine = cache_sim, controller, engine
        self.policy, self.build, self.scan = policy, _build, engine_scan
        self.ops, self.pool, self.kv = ops, pool, paged_kv
        self.att, self.configs, self.models = attention, configs, models
        self.serving = serving_engine
        self.obs, self.governor, self.stream = obs, governor, stream
        self.bursty = bursty_workload
        self.fleet, self.admission, self.autotune = fleet, admission, autotune
        self.overload, self.serv = overload, serv


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


def kernel_work():
    """``repro_torch.roofline.kernel_work``: each kernel's work by formula,
    the one count its wrapper charges the op counter and every bound below
    reads (imported once ``Env`` has put the checkout's ``src`` on the
    path)."""
    from repro_torch.roofline import kernel_work as kw
    return kw


def bound_ms(tier: str, pt, ways: int, rows=None) -> tuple:
    """Least time for one scan dispatch (``kernel_work.scan_work``: its
    columns and Stats, and its state ``rows`` read and written, against
    about 4 lane operations a way and active request plus 3 hashes on the
    extended tier, at the float32 peak)."""
    kw = kernel_work()
    cols = ((pt.conv_tag, pt.conv_write, pt.conv_active) if tier == "conv"
            else (pt.ext_tag, pt.ext_write, pt.ext_level, pt.ext_active))
    return kw.bound_ms(kw.scan_work(tier, cols, ways, rows))


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
            timing["conv_scan"] = dict(
                **times(lambda: scan.conv_scan(*conv_args),
                        lambda: scan.conv_scan_plain(*conv_args), 20, 2,
                        plain_on_graph=False),
                bound=bound_ms("conv", pt, cfg.conv_ways),
                shape=list(pt.conv_tag.shape))
            timing["ext_scan"] = dict(
                **times(lambda: scan.ext_scan(*ext_args),
                        lambda: scan.ext_scan_plain(*ext_args), 20, 2,
                        plain_on_graph=False),
                bound=bound_ms("ext", pt, cfg.ext_max_ways),
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


def pool_bound(name: str, args) -> tuple:
    """Least time for one call of pool wrapper ``name`` on ``args``
    (``kernel_work.pool_work``: the rows the call touches, against about 4
    operations a way, 6 a hash or segment and 1-2 a word read)."""
    kw = kernel_work()
    return kw.bound_ms(kw.pool_work(name, args))


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


def att_want(att, **counts) -> dict:
    """Every attention launch count ``att.launches`` keeps (its wrappers
    and the options' sub-counts): ``counts``, the others 0."""
    assert set(counts) <= set(att.launches), counts
    return {k: counts.get(k, 0) for k in att.launches}


def attention_bound(name: str, args, kwargs) -> tuple:
    """Least time for one attention call (``kernel_work.attention_work``:
    q, the keys and values it attends to, the mask and the output, each
    once, against 2 FLOPs a multiply-add of QK^T and of PV over the pairs
    the masks let through, at the card's peak for the input type)."""
    kw = kernel_work()
    return kw.bound_ms(kw.attention_work(name, args, kwargs))


def sdpa_call(name: str, args, kwargs):
    """One ``torch.nn.functional.scaled_dot_product_attention`` call on
    the same inputs (heads moved to dim 1 beforehand), timed as the
    library's time and never called by the port; None for a soft cap,
    which SDPA does not take."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if kwargs.get("softcap"):
        return None
    if name == "decode_attention":
        q, k, v, valid = args
        qt = q[:, :, None].contiguous()
        kt, vt = (a.transpose(1, 2).contiguous() for a in (k, v))
        mask = valid[:, None, None, :]
        return lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    q, k, v = (a.transpose(1, 2).contiguous() for a in args)
    s, t = q.shape[2], k.shape[2]
    causal, window = kwargs.get("causal", True), kwargs.get("window", 0)
    q_start = kwargs.get("q_start", 0)
    if window or q_start or (causal and s != t):
        i = torch.arange(q_start, q_start + s, device=q.device)[:, None]
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
    want = att_want(att, flash_attention=n_layers * len(rounds),
                    decode_attention=n_layers * steps)
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
    roofline = serving_roofline(env, model, r1, max_len, dev)
    kv_bytes = (n_layers * SERVE_BATCH * (SERVE_PROMPT + SERVE_NEW)
                * cfg.num_kv_heads * cfg.resolved_head_dim * 4 * 2)
    hbm = kernel_work().CHIP.hbm_Bps
    bound_w = weight_bytes / hbm * 1e3
    bound_kv = (weight_bytes + kv_bytes) / hbm * 1e3
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
            "prefill_window": pre_w, "decode_window": dec_w,
            "roofline": roofline}


def phase_attention_path(env: Env, calls: PathCalls,
                         label: str = "phase 13: the serving path") -> dict:
    """Phase 13 (and 16): every attention call of a serving phase, one per
    input shape, against its plain version, timed with its bound and
    SDPA's time where SDPA computes the same function."""
    att = env.att
    out = {}
    for key, args in calls.inputs.items():
        name, shapes, kw = key
        kwargs = dict(kw)
        kernel = getattr(att, name)
        plain = getattr(att, name + "_plain")
        err = att_close(kernel(*args, **kwargs), plain(*args, **kwargs),
                        att_tol(name, args[0].dtype),
                        f"{label} {name} {shapes}")
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
            fail(f"{label}: {name} was never called")
    log(f"{label}: attention kernels == plain at its shapes: "
        + "; ".join(
            f"{name} {t['shape']} {json.dumps(t['kwargs'])} "
            f"{t['dtype']} x{t['launches']}: {t['ms']:.4f} ms on the "
            f"card ({t['call_ms']:.4f} ms a call), plain {t['plain_ms']:.4f} "
            f"ms, SDPA " + ("none (no soft cap)" if t["library_ms"] is None
                            else f"{t['library_ms']:.4f} ms")
            + f", bound {t['bound'][0]:.4f} ms ({t['bound'][1]}), max abs "
            f"err {t['err']:.3g}" for name, rows in out.items()
            for t in rows))
    return out


# ------------------------------------------------------- online runtime

ONLINE_SYSTEM = "Morpheus-ALL"
HANDOFF_EPOCH = 40           # (c): the stationary cell's state after it
PROFILED_EPOCHS = (30, 35)   # (f): the profiled window of the replay
RING_EPOCHS, SNAPSHOT_EPOCH = 40, 20       # (d)
GOVERNED_PROMPTS = 40        # (e): phase 7's traffic, one tick a prompt
ONLINE_SPANS = ("online.replica", "online.pack", "online.advance",
                "online.consume", "stream.handoff", "governor.decide")


def online_cell(env: Env, cell: dict, dev):
    """(result, candidates) of one golden cell through the port's
    ``simulate_online``, as ``tests/test_torch_golden_online.py`` runs the
    reference's."""
    gov = env.governor
    gcfg = gov.SERVING_GCFG if cell["gcfg"] == "serving" \
        else gov.GovernorConfig()
    fixed = tuple(cell["fixed_split"]) if cell["fixed_split"] else None
    if "mix" in cell:
        wl = env.bursty(cell["mix"], cell["arrival"], length=cell["length"],
                        n_cores=cell["n_cores"], seed=cell["seed"])
        cands = gov.candidates_for(wl.primary_app, ONLINE_SYSTEM,
                                   grid=cell["ladder"],
                                   length=cell["length"])
        return gov.simulate_online(
            wl, ONLINE_SYSTEM, target_epoch=cell["target_epoch"],
            candidates=cands, gcfg=gcfg, fixed_split=fixed, device=dev), cands
    phases = online_phases(cell)
    cands = gov.candidates_for(online_primary(env, cell), ONLINE_SYSTEM,
                               grid=cell["ladder"], length=cell["length"])
    return gov.simulate_online(
        phases, ONLINE_SYSTEM, length=cell["length"],
        epoch_len=cell["epoch_len"], candidates=cands, gcfg=gcfg,
        fixed_split=fixed, device=dev), cands


def online_phases(cell: dict):
    p = cell["phases"]
    return p[0] if len(p) == 1 else tuple(p)


def online_primary(env: Env, cell: dict) -> str:
    p = cell["phases"]
    if len(p) == 1:
        return p[0]
    return next((a for a in p if env.governor.tr.WORKLOADS[a].memory_bound),
                p[0])


def online_check(env: Env, cell: dict, r, cands) -> float:
    """Hold one run to its golden record: candidates, decisions, splits
    and integer Stats identical, float Stats within FLOAT_RTOL, per-tenant
    integer Stats identical and summing to the global ones.  Returns the
    largest relative float error."""
    name = cell["name"]
    got = {"candidates": [list(c) for c in cands],
           "epochs": len(r.records), "switches": int(r.switches),
           "decisions": [[d.epoch, d.trigger, list(d.from_split),
                          list(d.to_split), int(d.flush_writebacks)]
                         for d in r.decisions],
           "splits": [[x.n_compute, x.n_cache] for x in r.records],
           "int_stats": {f: int(np.asarray(getattr(r.stats, f)))
                         for f in env.ctl._INT_FIELDS}}
    for key, card in got.items():
        ref = cell[key]
        if card == ref:
            continue
        if isinstance(card, list):      # name the first differing entry
            i = next((i for i, (a, b) in enumerate(zip(card, ref))
                      if a != b), min(len(card), len(ref)))
            card, ref = card[i:i + 1], ref[i:i + 1]
            key = f"{key}[{i}]"
        fail(f"online {name}: {key} differs from the reference's: card "
             f"{card}, reference {ref}")
    worst = 0.0
    for f, want in cell["float_stats"].items():
        v = float(np.asarray(getattr(r.stats, f)))
        rel = abs(v - want) / max(abs(want), 1.0)
        worst = max(worst, rel)
        if rel > FLOAT_RTOL:
            fail(f"online {name}: float {f} {v} vs the reference's {want}")
    if "tenant_int_stats" in cell:
        tenants = {n: {f: int(np.asarray(getattr(s, f)))
                       for f in env.ctl._INT_FIELDS}
                   for n, s in r.tenant_stats.items()}
        if tenants != cell["tenant_int_stats"]:
            fail(f"online {name}: per-tenant Stats differ from the "
                 f"reference's")
        for f, v in got["int_stats"].items():
            if sum(t[f] for t in tenants.values()) != v:
                fail(f"online {name}: per-tenant {f} does not sum to the "
                     f"global {v}")
    return worst


def online_run(env: Env, cell: dict, dev) -> dict:
    """One golden cell on the card, with the scan counts set to 0 just
    before and read just after, the obs tracer's spans (the host split)
    and counters on; fail unless each stateful scan launched once an
    epoch that has its tier, no plain version ran, and the run equals the
    reference's."""
    obs, scan = env.obs, env.scan
    obs.enable(trace=True, metrics=True)
    torch.cuda.synchronize()
    scan.reset_launches()
    t0 = time.perf_counter()
    r, cands = online_cell(env, cell, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(scan.launches), dict(scan.plain_runs)
    spans = obs.tracer().summary()
    counters = obs.bench_counters()
    obs.disable()
    err = online_check(env, cell, r, cands)
    ext_epochs = sum(1 for x in r.records if x.n_cache > 0)
    want = {"conv_scan": len(r.records), "ext_scan": ext_epochs}
    if launches != want or any(plain.values()):
        fail(f"online {cell['name']}: launches {launches} (expected {want} "
             f"from the epochs' splits), plain runs {plain}")
    if not counters["dispatches"] == len(r.records) == counters["epochs"]:
        fail(f"online {cell['name']}: counters {counters}")
    host = {k: spans.get(k, {}).get("total_us", 0.0) / 1e6
            for k in ONLINE_SPANS}
    n_req = sum(x.requests for x in r.records)
    out = {"name": cell["name"], "wall_s": wall, "epochs": len(r.records),
           "epochs_per_s": len(r.records) / wall,
           "requests_per_s": n_req / wall, "requests": n_req,
           "switches": int(r.switches), "decisions": len(r.decisions),
           "launches": launches, "host_s": host, "float_rel_err": err,
           "flush_writebacks": counters["flush_writebacks"],
           "ipc": r.ipc, "converged_split": list(r.converged_split)}
    log(f"phase 14: online {cell['name']}: {len(r.records)} epochs, "
        f"{n_req} requests in {wall:.3f} s ({out['epochs_per_s']:.2f} "
        f"epochs/s, {out['requests_per_s']:.0f} simulated requests/s); "
        f"{len(r.decisions)} decisions, {r.switches} switches, decisions, "
        f"splits and integer Stats == the reference's (float rel err "
        f"{err:.3g}); launches {json.dumps(launches)}; host s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in host.items()))
    return out


def online_step(env: Env, rep, dev, ev=None) -> None:
    """One epoch of an ``OnlineReplica`` as ``simulate_online`` runs it;
    with ``ev`` (a list) the ``advance_packed`` call's CUDA-event ms is
    appended."""
    engine = env.engine
    cfg, traces, pos0, count = rep.epoch_inputs()
    pt = engine.pack(cfg, traces, pos0=pos0, count=count)
    if ev is not None:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
    state, delta = engine.advance_packed(cfg, pt, rep.state, dev)
    if ev is not None:
        e1.record()
    host = env.ctl.Stats(*[x.cpu().numpy() for x in delta])
    if ev is not None:
        ev.append(e0.elapsed_time(e1))
    rep.consume(state, host)


def state_bound(tier: str, pt, rows) -> tuple:
    """``bound_ms`` of a stateful scan: its columns and Stats, and its
    state rows read once and written once."""
    return bound_ms(tier, pt, rows.tags.shape[-1], rows)


def online_handoff(env: Env, cell: dict, dev) -> dict:
    """(c) and (f): the stationary cell replayed through ``OnlineReplica``
    up to epoch ``HANDOFF_EPOCH`` (each ``advance_packed`` timed by CUDA
    events, epochs ``PROFILED_EPOCHS`` profiled), its state handed off to
    a split of the other size, and the next epoch through both stateful
    scans on the card and their plain versions on the same rows."""
    gov, engine, scan, stream = env.governor, env.engine, env.scan, \
        env.stream
    cands = gov.candidates_for(online_primary(env, cell), ONLINE_SYSTEM,
                               grid=cell["ladder"], length=cell["length"])
    rep = gov.OnlineReplica(online_phases(cell), ONLINE_SYSTEM,
                            length=cell["length"],
                            epoch_len=cell["epoch_len"], candidates=cands,
                            device=dev)
    ev_ms = []
    window = None
    while rep.epoch_i <= HANDOFF_EPOCH:
        if rep.epoch_i == PROFILED_EPOCHS[0]:
            n = PROFILED_EPOCHS[1] - PROFILED_EPOCHS[0]
            wall, us = profiled(lambda: [online_step(env, rep, dev)
                                         for _ in range(n)])
            by = {k: sum(v for name, v in us.items() if k in name) / 1e3
                  for k in ("conv_scan_kernel", "ext_scan_kernel")}
            window = {"epochs": n, "wall_s": wall,
                      "scan_ms": sum(by.values()),
                      "device_busy_ms": sum(us.values()) / 1e3,
                      "by_kernel_ms": by, "measured": bool(us)}
            continue
        online_step(env, rep, dev, ev_ms)
    splits = [[x.n_compute, x.n_cache] for x in rep.records]
    if splits != cell["splits"][:len(splits)]:
        fail("online handoff: the replay's splits differ from the "
             "reference's")
    nc, nk = rep.gov.current
    spec = env.cs.SYSTEMS[ONLINE_SYSTEM]
    other = next(c for c in cands if c[1] > 0 and c[1] != nk)
    old_cfg = env.cs.build_config(spec, nk)
    new_cfg = env.cs.build_config(spec, other[1])
    state, report = stream.handoff(old_cfg, rep.state, new_cfg,
                                   migrate=True)
    if not (report.migrated > 0 and report.resident_before > 0):
        fail(f"online handoff: nothing migrated ({report})")
    lo, hi = rep.epoch_bounds[rep.epoch_i]
    a, w, l = rep.trace_of[other[0]]
    pt = engine.to_device(engine.pack(new_cfg, [(a[lo:hi], w[lo:hi],
                                                 l[lo:hi], 0)], pos0=[lo]),
                          dev)
    warm = pt.warmup[:, None, None]
    crows = env.ctl.ConvRow(*[getattr(state, f)
                              for f in engine._CONV_FIELDS])
    erows = env.ctl.ExtRow(*[getattr(state, f) for f in engine._EXT_FIELDS])
    cargs = (new_cfg, pt.conv_tag, pt.conv_write, pt.conv_active,
             pt.conv_active & (pt.conv_pos >= warm))
    eargs = (new_cfg, pt.ext_tag, pt.ext_write, pt.ext_level,
             pt.ext_active, pt.ext_active & (pt.ext_pos >= warm))
    scan.reset_launches()
    err = {"conv_scan": compare(
        scan.conv_scan(*cargs, state=crows, keep_state=True),
        scan.conv_scan_plain(*cargs, state=crows, keep_state=True),
        "online handoff conv_scan"),
        "ext_scan": compare(
        scan.ext_scan(*eargs, state=erows, keep_state=True),
        scan.ext_scan_plain(*eargs, state=erows, keep_state=True),
        "online handoff ext_scan")}
    if scan.launches != {"conv_scan": 1, "ext_scan": 1}:
        fail(f"online handoff: launches {scan.launches}")
    timing = {}
    reps = 20
    for name, kernel, plain, tier, rows in (
            ("conv_scan",
             lambda: scan.conv_scan(*cargs, state=crows, keep_state=True),
             lambda: scan.conv_scan_plain(*cargs, state=crows,
                                          keep_state=True), "conv", crows),
            ("ext_scan",
             lambda: scan.ext_scan(*eargs, state=erows, keep_state=True),
             lambda: scan.ext_scan_plain(*eargs, state=erows,
                                         keep_state=True), "ext", erows)):
        # the stateful wrappers read the row contract's verdict back to
        # the host, so no CUDA graph holds them: the kernel's own device
        # time comes from the profiler (CUDA events back to back if it
        # recorded no device activity)
        call_ms = timed_cuda(kernel, reps)
        _, us = profiled(lambda: [kernel() for _ in range(reps)])
        k_us = sum(v for k, v in us.items() if f"{tier}_scan_kernel" in k)
        timing[name] = {"ms": k_us / 1e3 / reps if k_us else call_ms,
                        "ms_by": "torch.profiler" if k_us else
                        "CUDA events, back to back",
                        "call_ms": call_ms,
                        "plain_ms": timed_cuda(plain, 2),
                        "bound": state_bound(tier, pt, rows),
                        "shape": list(pt.conv_tag.shape if tier == "conv"
                                      else pt.ext_tag.shape),
                        "ways": rows.tags.shape[-1]}
    adv = sorted(ev_ms)
    out = {"from_split": [nc, nk], "to_split": list(other),
           "report": {k: v for k, v in dataclasses.asdict(report).items()
                      if k != "dropped_dirty_addr"},
           "err": err, "timing": timing, "window": window,
           "advance_ms_mean": sum(ev_ms) / len(ev_ms),
           "advance_ms_median": adv[len(adv) // 2],
           "advance_epochs": len(ev_ms)}
    wtext = ("not measured (torch.profiler recorded no device activity)"
             if not window["measured"] else
             f"host {window['wall_s']:.4f} s, device "
             f"{window['device_busy_ms']:.3f} ms, scans "
             f"{window['scan_ms']:.3f} ms ({json.dumps(window['by_kernel_ms'])})")
    log(f"phase 14: online handoff: the stationary cell's state after "
        f"epoch {HANDOFF_EPOCH} at ({nc}, {nk}) handed off to {other} "
        f"({out['report']}); the next epoch through both stateful scans == "
        f"plain on the same rows (integer Stats and rows identical, max abs "
        f"float err conv {err['conv_scan']:.3g}, ext {err['ext_scan']:.3g}); "
        + "; ".join(f"{k} {v['shape']}, {v['ways']} ways: "
                    f"{v['ms']:.5f} ms on the card ({v['ms_by']}), "
                    f"{v['call_ms']:.4f} ms a call, "
                    f"plain {v['plain_ms']:.2f} ms, bound "
                    f"{v['bound'][0]:.5f} ms ({v['bound'][1]})"
                    for k, v in timing.items())
        + f"; advance_packed by CUDA events over {len(ev_ms)} epochs: mean "
        f"{out['advance_ms_mean']:.3f} ms, median "
        f"{out['advance_ms_median']:.3f} ms; profiled window of epochs "
        f"{PROFILED_EPOCHS[0]}-{PROFILED_EPOCHS[1] - 1}: {wtext}")
    return out


def online_ring(env: Env, cell: dict, dev) -> None:
    """(d): an ``EpochStream`` over the stationary cell's trace at the
    split (48, 20) with ``ring=0``; the same with ``ring=2``, whose
    snapshot at epoch ``SNAPSHOT_EPOCH`` goes through ``save_state`` and
    ``load_state`` into a third stream (``ring=2``) that resumes: every
    epoch's Stats, the final rows and Stats identical."""
    stream, tr = env.stream, env.governor.tr
    spec = env.cs.SYSTEMS[ONLINE_SYSTEM]
    nc, nk = 48, 20
    cfg = env.cs.build_config(spec, nk)
    length = RING_EPOCHS * cell["epoch_len"]
    a, w, l = tr.generate_phased([cell["phases"][0]], n_cores=nc,
                                 length=cell["length"], seed=0,
                                 ws_scale=1.0 / env.cs.SIM_SCALE)
    a, w, l = a[:length], w[:length], l[:length]
    path = ROOT / "build" / "chip_smoke" / "online_state.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    runs = {}
    for ring in (0, 2):
        s = stream.EpochStream(cfg, a, w, l, epoch_len=cell["epoch_len"],
                               ring=ring, device=dev)
        deltas = []
        while not s.done:
            if ring and s.epoch == SNAPSHOT_EPOCH:
                stream.save_state(path, s.snapshot())
            deltas.append([x.clone() for x in s.step()])
        runs[ring] = (deltas, s.state)
    resumed = stream.EpochStream(cfg, a, w, l, epoch_len=cell["epoch_len"],
                                 ring=2, device=dev)
    snap = stream.load_state(path, cfg)
    resumed.restore(snap)
    tail = [[x.clone() for x in resumed.step()] for _ in
            range(RING_EPOCHS - SNAPSHOT_EPOCH)]
    if not resumed.done:
        fail("online ring: the resumed stream did not reach the end")
    for i, (d0, d2) in enumerate(zip(runs[0][0], runs[2][0])):
        if not all(torch.equal(x, y) for x, y in zip(d0, d2)):
            fail(f"online ring: epoch {i} Stats of ring=2 != ring=0")
    for i, (d0, d2) in enumerate(zip(runs[0][0][SNAPSHOT_EPOCH:], tail)):
        if not all(torch.equal(x, y) for x, y in zip(d0, d2)):
            fail(f"online resume: epoch {SNAPSHOT_EPOCH + i} Stats differ")
    for st in (runs[2][1], resumed.state):
        same = all(torch.equal(x, y) for x, y in
                   zip(runs[0][1][:-2], st[:-2])) and \
            all(torch.equal(x, y) for x, y in zip(runs[0][1].stats,
                                                  st.stats)) and \
            torch.equal(runs[0][1].pos, st.pos)
        if not same:
            fail("online ring/resume: final rows or Stats differ")
    log(f"phase 14: online state file and ring: {RING_EPOCHS} epochs at "
        f"({nc}, {nk}); ring=2 == ring=0 every epoch; snapshot at epoch "
        f"{SNAPSHOT_EPOCH} -> save_state -> load_state -> resume == the "
        f"uninterrupted run (rows, Stats, position)")


def online_serving(env: Env, dev) -> dict:
    """(e): ``ServingGovernor`` ticking once a prompt over ``demo_pool``
    under phase 7's chat traffic, on the card and on the CPU: tick
    records, ``PoolStats``, flushed pages and decisions identical; on the
    card the pool launches what phase 7 requires per lookup."""
    gov, kv, kp = env.governor, env.kv, env.pool
    prompts = list(chat_prompts(GOVERNED_PROMPTS))
    out = {}
    for where in (dev, "cpu"):
        pool = gov.demo_pool(4, device=where)
        sg = gov.ServingGovernor(pool)
        installed, writes = {}, 0
        kp.reset_launches()
        t0 = time.perf_counter()
        for i, prompt in enumerate(prompts):
            writes += serve_request(pool, kv.page_key, prompt, installed,
                                    f"governed prompt {i}")
            sg.tick()
        wall = time.perf_counter() - t0
        out[str(where)] = dict(history=sg.history, stats=tuple(pool.stats),
                               decisions=[e.to_dict()
                                          for e in sg.gov.decisions],
                               launches=dict(kp.launches),
                               plain=dict(kp.plain_runs), writes=writes,
                               wall_s=wall)
    card, cpu = out[str(dev)], out["cpu"]
    for key in ("history", "stats", "decisions", "writes"):
        if card[key] != cpu[key]:
            fail(f"online serving governor: {key} on the card differs from "
                 f"the CPU's")
    s = kv.PoolStats(*card["stats"])
    ext = s.ext_hits + s.ext_false_pos + s.ext_pred_miss
    want = {"lookup_fill": s.conv_hits + s.conv_misses, "bloom_query": ext,
            "bloom_record": ext, "page_write": card["writes"],
            "read_rows": s.conv_hits + s.ext_hits, "tag_lookup": 0,
            "bdi_compress": 0}
    got = {k: card["launches"][k] for k in want}
    if got != want or any(card["plain"].values()):
        fail(f"online serving governor: launches {got}, expected {want}; "
             f"plain runs {card['plain']}")
    switched = sum(r["switched"] for r in card["history"])
    flushed = sum(r["flushed_pages"] for r in card["history"])
    log(f"phase 14: online serving governor: {GOVERNED_PROMPTS} prompts, "
        f"one tick each, on the card in {card['wall_s']:.3f} s (CPU "
        f"{cpu['wall_s']:.3f} s); tick records, PoolStats, decisions and "
        f"{flushed} flushed pages over {switched} switches == the CPU's "
        f"(chips {[r['chips'] for r in card['history']]}); launches "
        f"{json.dumps(got)} as phase 7 requires")
    return {"switches": switched, "flushed": flushed, "launches": got,
            "wall_s": card["wall_s"]}


def phase_online(env: Env, dev) -> dict:
    """Phase 14: the online runtime on the card at the figure scripts'
    full-profile cells, held to ``tests/data/torch_golden_online.json``."""
    golden = json.loads(GOLDEN_ONLINE.read_text())
    cells = [dict(c, ladder=golden["ladder_grid"]) for c in golden["cells"]]
    runs = [online_run(env, c, dev) for c in cells]
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in ("conv_scan", "ext_scan")}
    stationary = next(c for c in cells if c["name"] == "stationary")
    handoff = online_handoff(env, stationary, dev)
    online_ring(env, stationary, dev)
    serving = online_serving(env, dev)
    return {"cells": runs, "launches": launches, "handoff": handoff,
            "serving": serving}


# ------------------------------------------------------------ phase 15

FLEET_PREFIXES = (1, 4, 16)
FLEET_PROFILED_STEPS = 3     # the profiled window of the B = 64 group
FLEET_WARM_STEPS = 4         # fixed-split steps before that window
FLEET_HEAVY_SPLIT = (18, 50)     # the cache-heavy split: 983 KB a row
ADVISOR_WAVE_SEED = 50


def fleet_specs(env: Env, g: dict, n: int, seed0: int = 0, **kw):
    """``benchmarks/fig_fleet.py``'s replicas, as
    ``tests/test_torch_golden_fleet.py`` builds them: replica i serves
    ``apps[i % 4]`` with seed ``seed0 + i`` on its app's ladder."""
    apps = g["apps"]
    ladders = {a: env.governor.candidates_for(
        a, ONLINE_SYSTEM, grid=tuple(g["ladder_grid"]), length=g["length"])
        for a in apps}
    return [env.fleet.ReplicaSpec(apps[i % len(apps)], ONLINE_SYSTEM,
                                  length=g["length"],
                                  epoch_len=g["epoch_len"], seed=seed0 + i,
                                  candidates=ladders[apps[i % len(apps)]],
                                  name=f"r{i}:{apps[i % len(apps)]}", **kw)
            for i in range(n)]


def replica_record(env: Env, r) -> dict:
    """The golden record of one replica's run (the test's
    ``replica_record``)."""
    return {"splits": [[x.n_compute, x.n_cache] for x in r.records],
            "decisions": [d.compact() for d in r.decisions],
            "switches": int(r.switches),
            "int_stats": {f: int(np.asarray(getattr(r.stats, f)))
                          for f in env.ctl._INT_FIELDS},
            "float_stats": {f: float(np.asarray(getattr(r.stats, f)))
                            for f in r.stats._fields
                            if f not in env.ctl._INT_FIELDS},
            "ipc": float(r.ipc),
            "rewards": [float(x.reward) for x in r.records]}


def first_diff(got, want) -> str:
    """The first differing key or index of two golden records."""
    if isinstance(want, dict):
        k = next(k for k in want if got.get(k) != want[k])
        return f"{k}: {first_diff(got.get(k), want[k])}"
    if isinstance(want, list) and isinstance(got, list) and \
            len(got) == len(want):
        i = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        return f"[{i}] card {got[i]}, reference {want[i]}"
    return f"card {got}, reference {want}"


def hold_replica(got: dict, want: dict, ctx: str) -> float:
    """Decisions, splits and integer Stats identical, floats (Stats, ipc,
    rewards) within FLOAT_RTOL; returns the largest relative error."""
    for key in ("splits", "decisions", "switches", "int_stats"):
        if got[key] != want[key]:
            fail(f"{ctx}: {key} differs from the reference's: "
                 f"{first_diff(got[key], want[key])}")
    pairs = [(got["float_stats"][f], w)
             for f, w in want["float_stats"].items()]
    pairs += [(got["ipc"], want["ipc"])]
    pairs += list(zip(got["rewards"], want["rewards"]))
    worst = max(abs(a - b) / max(abs(b), 1.0) for a, b in pairs)
    if worst > FLOAT_RTOL:
        fail(f"{ctx}: a float is {worst:.3g} relative from the reference's")
    return worst


def same_replica(a, b, ctx: str) -> float:
    """The reference test's fleet identity (tests/test_fleet.py): integer
    Stats, decisions and switches identical, ``ipc`` and every epoch's
    reward within 1e-9 relative; returns the largest relative error."""
    for key in ("splits", "decisions", "switches", "int_stats"):
        if a[key] != b[key]:
            fail(f"{ctx}: {key} differs: {first_diff(a[key], b[key])}")
    pairs = [(a["ipc"], b["ipc"])] + list(zip(a["rewards"], b["rewards"]))
    worst = max(abs(x - y) / max(abs(y), 1.0) for x, y in pairs)
    if worst > 1e-9:
        fail(f"{ctx}: ipc or a reward differs by {worst:.3g} relative "
             f"(bound 1e-9)")
    return worst


def fleet_groups(results) -> tuple:
    """(engine calls, calls whose group has cache cores) of a fleet run,
    from its replicas' splits: one call a distinct config a step, and a
    config is its cache-core count."""
    n = max(len(r.records) for r in results)
    calls = ext = 0
    for e in range(n):
        nks = {r.records[e].n_cache for r in results if len(r.records) > e}
        calls += len(nks)
        ext += sum(1 for nk in nks if nk > 0)
    return calls, ext


def group_syncs(env: Env, reps, dev) -> list:
    """One fleet step of ``reps`` with CUDA's sync debug mode on: the
    synchronising calls each group's ``_advance_group`` makes, as (rows,
    calls, whether the split has cache cores, calls by source line)."""
    import warnings
    groups = {}
    for rep in reps:
        if not rep.done:
            cfg, traces, pos0, count = rep.epoch_inputs()
            groups.setdefault(cfg, []).append((rep, traces, pos0, count))
    out = []
    for cfg, group in groups.items():
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                env.fleet._advance_group(cfg, group, dev)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sites = {}
        for w in seen:
            if "synchroniz" in str(w.message):
                k = f"{Path(w.filename).name}:{w.lineno}"
                sites[k] = sites.get(k, 0) + 1
        out.append((len(group), sum(sites.values()), cfg.amap.ext_sets > 0,
                    sites))
    return out


def fleet_main(env: Env, g: dict, dev) -> dict:
    """(a)-(c): the 64-replica fleet against the golden file, the card's
    serial loop and the prefixes."""
    obs, scan, fleet = env.obs, env.scan, env.fleet
    specs = fleet_specs(env, g, g["replicas"])
    obs.enable(trace=True, metrics=True)
    torch.cuda.synchronize()
    scan.reset_launches()
    t0 = time.perf_counter()
    fr = fleet.simulate_fleet(specs, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(scan.launches), dict(scan.plain_runs)
    counters = obs.bench_counters()
    spans = obs.tracer().summary()
    obs.disable()
    if fr.names != g["names"] or fr.epochs != g["epochs"]:
        fail(f"fleet: names or steps differ ({fr.epochs} steps, golden "
             f"{g['epochs']})")
    recs = [replica_record(env, r) for r in fr.results]
    err = max(hold_replica(got, want, f"fleet replica {i}")
              for i, (got, want) in enumerate(zip(
                  recs, g["replicas_results"])))
    calls, ext_calls = fleet_groups(fr.results)
    want = {"conv_scan": fr.dispatches, "ext_scan": ext_calls}
    if calls != fr.dispatches or fr.dispatches != g["dispatches"] or \
            launches != want or any(plain.values()) or \
            counters["dispatches"] != fr.dispatches:
        fail(f"fleet: launches {launches}, expected {want} from the groups "
             f"({calls} engine calls, FleetResult.dispatches "
             f"{fr.dispatches}, golden {g['dispatches']}, counter "
             f"{counters['dispatches']}); plain runs {plain}")
    # (b) the card's own serial loop, same process
    scan.reset_launches()
    t0 = time.perf_counter()
    serial = fleet.run_serial(fleet_specs(env, g, g["replicas"]), device=dev)
    torch.cuda.synchronize()
    serial_wall = time.perf_counter() - t0
    serial_launches = dict(scan.launches)
    serial_err = max(same_replica(replica_record(env, s), rec,
                                  f"fleet vs serial, replica {i}")
                     for i, (s, rec) in enumerate(zip(serial, recs)))
    # (c) prefixes: replica i of N replicas == replica i of 64
    prefix_err = 0.0
    for n in FLEET_PREFIXES:
        small = fleet.simulate_fleet(fleet_specs(env, g, n), device=dev)
        prefix_err = max(prefix_err, max(
            same_replica(replica_record(env, r), recs[i],
                         f"fleet prefix N={n}, replica {i}")
            for i, r in enumerate(small.results)))
    rep_epochs = sum(len(r.records) for r in fr.results)
    group_us = spans.get("fleet.group_step", {}).get("total_us", 0.0)
    out = {"wall_s": wall, "serial_wall_s": serial_wall,
           "replica_epochs": rep_epochs,
           "replica_epochs_per_s": rep_epochs / wall,
           "serial_replica_epochs_per_s": rep_epochs / serial_wall,
           "steps": fr.epochs, "dispatches": fr.dispatches,
           "dispatches_per_step": fr.dispatches / fr.epochs,
           "launches": launches, "serial_launches": serial_launches,
           "device_get_bytes_per_dispatch":
               counters["device_get_bytes"] / fr.dispatches,
           "group_step_s": group_us / 1e6, "float_rel_err": err,
           "serial_rel_err": serial_err, "prefix_rel_err": prefix_err,
           "records": recs, "aggregate_ipc": fr.aggregate_ipc(),
           "mean_convergence_epoch": float(np.mean(
               fr.convergence_epochs()))}
    log(f"phase 15: fleet of {g['replicas']} replicas x {g['epochs']} "
        f"epochs: {wall:.3f} s, {out['replica_epochs_per_s']:.1f} "
        f"replica-epochs/s; serial loop on the card {serial_wall:.3f} s, "
        f"{out['serial_replica_epochs_per_s']:.1f} replica-epochs/s "
        f"(fleet {out['replica_epochs_per_s'] / out['serial_replica_epochs_per_s']:.2f}x); "
        f"{fr.dispatches} dispatches ({out['dispatches_per_step']:.2f} a "
        f"step), launches {json.dumps(launches)} == the groups' (serial "
        f"{json.dumps(serial_launches)}), no plain run; decisions, splits and "
        f"integer Stats == the reference's (float rel err {err:.3g}); fleet "
        f"== serial (rel err {serial_err:.3g}, bound 1e-9); prefixes N = "
        f"{FLEET_PREFIXES} == N = {g['replicas']} (rel err "
        f"{prefix_err:.3g}); device_get_bytes "
        f"{out['device_get_bytes_per_dispatch']:.0f} a group epoch; host "
        f"s in fleet.group_step {out['group_step_s']:.3f}")
    return out


def fleet_b64(env: Env, g: dict, dev) -> dict:
    """(d): the 64 replicas pinned at the cache-heavy split, so a step is
    one group of B = 64 rows: the synchronising calls of a group epoch,
    a profiled window of ``FLEET_PROFILED_STEPS`` steps, the state rows'
    contract check at B = 64, and both stateful scans at B = 64 against
    their plain versions on the same rows, with their bounds."""
    fleet, scan, engine = env.fleet, env.scan, env.engine
    reps = fleet.build_replicas(fleet_specs(
        env, g, g["replicas"], fixed_split=FLEET_HEAVY_SPLIT), device=dev)

    def step():
        groups = {}
        for rep in reps:
            cfg, traces, pos0, count = rep.epoch_inputs()
            groups.setdefault(cfg, []).append((rep, traces, pos0, count))
        for cfg, group in groups.items():
            fleet._advance_group(cfg, group, dev)

    for _ in range(FLEET_WARM_STEPS):
        step()
    syncs = group_syncs(env, reps, dev)
    scan.reset_launches()
    wall, us = profiled(lambda: [step() for _ in range(FLEET_PROFILED_STEPS)])
    if scan.launches != {"conv_scan": FLEET_PROFILED_STEPS,
                         "ext_scan": FLEET_PROFILED_STEPS}:
        fail(f"fleet B=64: launches {scan.launches} in "
             f"{FLEET_PROFILED_STEPS} one-group steps")
    by = {k: sum(v for name, v in us.items() if k in name) / 1e3
          / FLEET_PROFILED_STEPS
          for k in ("conv_scan_kernel", "ext_scan_kernel")}
    window = {"wall_s": wall, "device_ms": sum(us.values()) / 1e3,
              "by_kernel_ms": by, "measured": bool(us)}
    # the next epoch's group, packed as the fleet packs it
    spec = env.cs.SYSTEMS[ONLINE_SYSTEM]
    cfg = env.cs.build_config(spec, FLEET_HEAVY_SPLIT[1])
    traces, pos0 = [], []
    for rep in reps:
        c, t, p, _ = rep.epoch_inputs()
        traces += t
        pos0 += p
    state = fleet._cat_states([rep.state for rep in reps])
    pt = engine.to_device(engine.pack(cfg, traces, pos0=pos0), dev)
    warm = pt.warmup[:, None, None]
    crows = env.ctl.ConvRow(*[getattr(state, f)
                              for f in engine._CONV_FIELDS])
    erows = env.ctl.ExtRow(*[getattr(state, f) for f in engine._EXT_FIELDS])
    cargs = (cfg, pt.conv_tag, pt.conv_write, pt.conv_active,
             pt.conv_active & (pt.conv_pos >= warm))
    eargs = (cfg, pt.ext_tag, pt.ext_write, pt.ext_level, pt.ext_active,
             pt.ext_active & (pt.ext_pos >= warm))
    scan.reset_launches()
    err = {"conv_scan": compare(
        scan.conv_scan(*cargs, state=crows, keep_state=True),
        scan.conv_scan_plain(*cargs, state=crows, keep_state=True),
        "fleet B=64 conv_scan"),
        "ext_scan": compare(
        scan.ext_scan(*eargs, state=erows, keep_state=True),
        scan.ext_scan_plain(*eargs, state=erows, keep_state=True),
        "fleet B=64 ext_scan")}
    timing = {}
    reps_t = 10
    for name, kernel, plain, tier, rows in (
            ("conv_scan", lambda: scan.conv_scan(*cargs, state=crows,
                                                 keep_state=True),
             lambda: scan.conv_scan_plain(*cargs, state=crows,
                                          keep_state=True), "conv", crows),
            ("ext_scan", lambda: scan.ext_scan(*eargs, state=erows,
                                               keep_state=True),
             lambda: scan.ext_scan_plain(*eargs, state=erows,
                                         keep_state=True), "ext", erows)):
        call_ms = timed_cuda(kernel, reps_t)
        _, kus = profiled(lambda: [kernel() for _ in range(reps_t)])
        k_us = sum(v for k, v in kus.items() if f"{tier}_scan_kernel" in k)
        _, cus = profiled(lambda: scan.check_row_contract(tier, rows))
        timing[name] = {
            "ms": k_us / 1e3 / reps_t if k_us else call_ms,
            "ms_by": "torch.profiler" if k_us else
            "CUDA events, back to back", "call_ms": call_ms,
            "plain_ms": timed_cuda(plain, 1),
            "bound": state_bound(tier, pt, rows),
            "contract_ms": sum(cus.values()) / 1e3 if cus else None,
            "shape": list((pt.conv_tag if tier == "conv" else
                           pt.ext_tag).shape),
            "ways": rows.tags.shape[-1],
            "row_bytes": sum(x.element_size() * x.numel() for x in rows)}
    out = {"syncs": syncs, "window": window, "err": err, "timing": timing,
           "split": list(FLEET_HEAVY_SPLIT)}
    wtext = ("not measured (torch.profiler recorded no device activity)"
             if not us else
             f"{wall:.4f} s of host around {window['device_ms']:.3f} ms of "
             f"device time, scans a step {json.dumps(by)}")
    log(f"phase 15: fleet at B = {g['replicas']} (all replicas pinned at "
        f"{FLEET_HEAVY_SPLIT}): synchronising calls a group epoch (CUDA "
        f"sync debug mode; rows, calls, cache cores, by line) {syncs}; "
        f"profiled "
        f"{FLEET_PROFILED_STEPS} steps: {wtext}; the next group through "
        f"both stateful scans == plain on the same rows (max abs float err "
        f"conv {err['conv_scan']:.3g}, ext {err['ext_scan']:.3g}); "
        + "; ".join(f"{k} {v['shape']}, {v['ways']} ways, state rows "
                    f"{v['row_bytes'] / 1e6:.2f} MB: {v['ms']:.5f} ms on the "
                    f"card ({v['ms_by']}), {v['call_ms']:.4f} ms a call, "
                    f"plain {v['plain_ms']:.2f} ms, "
                    f"bound {v['bound'][0]:.5f} ms ({v['bound'][1]}), row "
                    f"contract check "
                    + (f"{v['contract_ms']:.4f} ms of device time"
                       if v["contract_ms"] is not None else "not measured")
                    for k, v in timing.items()))
    return out


def fleet_advisor(env: Env, g: dict, dev) -> dict:
    """(e): fig_fleet's advisor ablation: a cold fleet of 4 teaches; a
    fresh wave (seed offset 50) runs cold and warm."""
    fleet = env.fleet
    n = len(g["apps"])
    adv = fleet.SplitAdvisor()
    fleet.simulate_fleet(fleet_specs(env, g, n), device=dev, advisor=adv)
    advised = {mix: e["split"] for mix, e in adv.table.items()}
    wave = fleet_specs(env, g, n, seed0=ADVISOR_WAVE_SEED)
    cold = fleet.simulate_fleet(wave, device=dev)
    warm = fleet.simulate_fleet(wave, device=dev, advisor=adv)
    covered = [(i, r) for i, r in enumerate(warm.results)
               if (ONLINE_SYSTEM, (g["apps"][i % n],)) in advised]
    if adv.warm_starts != len(covered) or not covered:
        fail(f"fleet advisor: {adv.warm_starts} warm starts for "
             f"{len(covered)} mixes with advice")
    for i, r in covered:
        first = (r.records[0].n_compute, r.records[0].n_cache)
        if first != advised[(ONLINE_SYSTEM, (g["apps"][i % n],))]:
            fail(f"fleet advisor: warm replica {i} began at {first}")
    out = {"warm_starts": adv.warm_starts,
           "cold_convergence": float(np.mean(cold.convergence_epochs())),
           "warm_convergence": float(np.mean(warm.convergence_epochs()))}
    log(f"phase 15: advisor: {adv.warm_starts} warm starts, each at its "
        f"advised split at epoch 0; mean convergence epoch cold "
        f"{out['cold_convergence']:.2f}, warm {out['warm_convergence']:.2f}")
    return out


def overload_run(env: Env, o: dict, mode: str, dev) -> tuple:
    """(calibrated base ms, the calibration's result, the cell's result)
    of one overload cell, as
    ``benchmarks/fig_overload.py`` runs it (the golden test's
    ``overload_run``)."""
    adm, over, serv = env.admission, env.overload, env.serv
    base, seed, cal = o["base"], o["seed"], o["calibration"]

    def tenants(base_ms):
        return [serv.TenantSLO(n, o["slo_mult"][n] * base_ms, weight=w,
                               priority=p, app=app)
                for n, w, p, app in o["tenants"]]
    t1 = tenants(1.0)
    cal_res = adm.simulate_overload(
        t1, over.demand_schedule(over.LoadScenario(
            "calibrate", "sustained", 1.0, rounds=cal["rounds"], seed=seed),
            t1, base), system=ONLINE_SYSTEM, admission=None,
        fixed_split=tuple(cal["split"]), seed=seed,
        budgeter=serv.TenantSLOBudgeter(t1, min_total=base,
                                        max_total=8 * base,
                                        initial_total=8 * base), device=dev)
    base_ms = float(np.mean([r["round_ms"] for r in cal_res.rounds
                             if not r.get("idle")]))
    tt = tenants(base_ms)
    load = o["load"]
    res = adm.simulate_overload(
        tt, over.demand_schedule(over.LoadScenario(
            f"sustained{load:g}", "sustained", load, rounds=o["rounds"],
            seed=seed), tt, base), system=ONLINE_SYSTEM,
        admission=adm.AdmissionConfig() if mode == "admission" else None,
        budgeter=serv.TenantSLOBudgeter(tt, min_total=4,
                                        max_total=8 * base,
                                        initial_total=base,
                                        headroom=o["headroom"]),
        candidates=[tuple(c) for c in o["ladder"]], seed=seed, device=dev)
    return base_ms, cal_res, res


def overload_record(env: Env, res) -> dict:
    ints = env.ctl._INT_FIELDS
    return {"rounds": [[r.get("served", {}), r.get("deferred", {}),
                        r.get("shed", {}), list(r["split"])]
                       for r in res.rounds],
            "events_crc": zlib.crc32(";".join(
                e.compact() for e in res.events).encode()) & 0xFFFFFFFF,
            "events": len(res.events),
            "decisions": [d.compact() for d in res.decisions],
            "int_stats": {f: int(np.asarray(getattr(res.stats, f)))
                          for f in ints},
            "tenant_int_stats": {
                n: {f: int(np.asarray(getattr(s, f))) for f in ints}
                for n, s in res.tenant_stats.items()},
            "offered": res.offered, "served": res.served, "shed": res.shed,
            "backlog": res.backlog}


def phase_overload(env: Env, o: dict, dev) -> dict:
    """fig_overload's full profile at load 8 on the card, with and without
    admission control, held to the golden file; the scenario CRCs from
    the port's controller."""
    scan, adm, over, serv = env.scan, env.admission, env.overload, env.serv
    out = {}
    for mode in ("admission", "none"):
        scan.reset_launches()
        t0 = time.perf_counter()
        base_ms, cal_res, res = overload_run(env, o, mode, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = dict(scan.launches), dict(scan.plain_runs)
        if abs(base_ms - o["base_ms"]) > FLOAT_RTOL * o["base_ms"]:
            fail(f"overload: calibrated base {base_ms} ms, the reference's "
                 f"{o['base_ms']}")
        got = json.loads(json.dumps(overload_record(env, res)))
        if got != o[mode]:
            fail(f"overload {mode}: differs from the reference's: "
                 f"{first_diff(got, o[mode])}")
        if not res.attribution_exact() or any(
                res.offered[n] != res.served[n] + res.shed[n]
                + res.backlog[n] for n in res.offered):
            fail(f"overload {mode}: attribution or conservation broken")
        # one advance_packed a live round of both runs (K count-masked
        # rows): one conv_scan, and one ext_scan when the split has cache
        # cores
        live = [r for x in (cal_res, res) for r in x.rounds
                if not r.get("idle")]
        want = {"conv_scan": len(live),
                "ext_scan": sum(1 for r in live if r["split"][1] > 0)}
        if launches != want or any(plain.values()):
            fail(f"overload {mode}: launches {launches}, expected {want}; "
                 f"plain runs {plain}")
        out[mode] = {"wall_s": wall, "base_ms": base_ms,
                     "served": sum(res.served.values()),
                     "shed": sum(res.shed.values()),
                     "events": len(res.events), "launches": launches,
                     "attainment_hi": res.attainment["hi"]}
    sc = o["scenarios"]
    tenants = [serv.TenantSLO(n, slo, weight=w, priority=p, app=app)
               for n, slo, w, p, app in sc["tenants"]]
    budgets = dict(zip([t.name for t in tenants],
                       serv.apportion_largest_remainder(
                           [t.weight for t in tenants], sc["capacity"])))
    crcs = {}
    for name in sc["crcs"]:
        ctrl = adm.AdmissionController(tenants)
        for d in over.demand_schedule(over.SCENARIOS[name], tenants,
                                      sc["base_total"]):
            ctrl.plan(d, budgets)
        crcs[name] = zlib.crc32(";".join(
            e.compact() for e in ctrl.events).encode()) & 0xFFFFFFFF
    if crcs != sc["crcs"]:
        fail(f"overload: scenario CRCs {crcs}, pinned {sc['crcs']}")
    out["scenario_crcs"] = crcs
    a, n = out["admission"], out["none"]
    log(f"phase 15: overload, base {o['base']}, {o['rounds']} rounds at "
        f"load {o['load']:g}: calibrated base {a['base_ms']:.6g} ms (the "
        f"reference's {o['base_ms']:.6g}); with admission {a['wall_s']:.3f} "
        f"s, {a['served']} served, {a['shed']} shed, {a['events']} events, "
        f"hi attainment {a['attainment_hi']:.3f}; without {n['wall_s']:.3f} "
        f"s, {n['served']} served, hi attainment {n['attainment_hi']:.3f}; "
        f"rounds, events, decisions and integer Stats (global and per "
        f"tenant) == the reference's, attribution exact; launches "
        f"{json.dumps(a['launches'])} / {json.dumps(n['launches'])}; "
        f"scenario CRCs == tests/scenarios.py's {json.dumps(crcs)}")
    return out


def phase_autotune(env: Env, a: dict, dev) -> dict:
    """fig_autotune's quick budgets on the card: the governor search over
    the two quick cells and the hardware search over ``hw_space()``, held
    to the golden file (configs identical, scores within FLOAT_RTOL, one
    dispatch a generation)."""
    at = env.autotune
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    for name in ("gov", "hw"):
        spec = a[name]
        if name == "gov":
            obj = at.GovernorObjective([tuple(c) for c in spec["cells"]],
                                       length=spec["length"], device=dev)
            space = at.gov_space()
        else:
            obj = at.HardwareObjective(spec["app"], length=spec["length"],
                                       device=dev)
            space = at.hw_space()
        path = out_dir / f"autotune_{name}.jsonl"
        path.unlink(missing_ok=True)
        t0 = time.perf_counter()
        res = at.Tuner(space, obj, at.make_agent(
            spec["agent"], space, seed=spec["seed"], pop=spec["pop"]),
            trajectory_path=path).run(spec["generations"])
        wall = time.perf_counter() - t0
        doc = at.read_trajectory(path)
        keys = [gen["keys"] for gen in doc["generations"]]
        scores = [gen["scores"] for gen in doc["generations"]]
        if keys != spec["keys"]:
            fail(f"autotune {name}: configs differ from the reference's: "
                 f"{first_diff(keys, spec['keys'])}")
        pairs = [(x, y) for gs, ws in zip(scores, spec["scores"])
                 for x, y in zip(gs, ws)]
        if name == "gov":
            pairs += list(zip(obj.best_static_ipcs(),
                              spec["best_static_ipcs"]))
        worst = max(0.0 if x == y else abs(x - y) / max(abs(y), 1.0)
                    for x, y in pairs)
        if worst > FLOAT_RTOL or res.best_config != spec["best_config"] \
                or obj.dispatches != spec["generations"]:
            fail(f"autotune {name}: scores {worst:.3g} relative from the "
                 f"reference's, best {res.best_config} (reference "
                 f"{spec['best_config']}), {obj.dispatches} dispatches")
        out[name] = {"wall_s": wall, "best_score": res.best_score,
                     "float_rel_err": worst, "dispatches": obj.dispatches}
    log(f"phase 15: autotune (fig_autotune quick): governor GA "
        f"{a['gov']['pop']} x {a['gov']['generations']} on 2 cells in "
        f"{out['gov']['wall_s']:.3f} s, best ratio "
        f"{out['gov']['best_score']:.5f}; hardware hill climb "
        f"{a['hw']['pop']} x {a['hw']['generations']} in "
        f"{out['hw']['wall_s']:.3f} s, best IPC {out['hw']['best_score']:.4f};"
        f" each generation's configs == the reference's, scores within "
        f"{max(out['gov']['float_rel_err'], out['hw']['float_rel_err']):.3g}"
        f" relative, one dispatch a generation")
    return out


def phase_fleet(env: Env, dev) -> dict:
    """Phase 15: the fleet, admission control and the autotuner on the
    card at the reference figures' settings, held to
    ``tests/data/torch_golden_fleet.json``."""
    golden = json.loads(GOLDEN_FLEET.read_text())
    return {"fleet": fleet_main(env, golden["fleet"], dev),
            "b64": fleet_b64(env, golden["fleet"], dev),
            "advisor": fleet_advisor(env, golden["fleet"], dev),
            "overload": phase_overload(env, golden["overload"], dev),
            "autotune": phase_autotune(env, golden["autotune"], dev)}


# ---------------------------------------------------- every model family

GOLDEN_SUBSTRATES = ROOT / "tests" / "data" / "torch_golden_substrates.json"
# (b): each family served by Engine at full width; depth None is the
# config's own, "reduced" its reduced() config (jamba-1.5-large's full
# width needs more than one card; the production dry run counts it)
SUB_SERVE = (("mamba2-780m", None), ("seamless-m4t-medium", None),
             ("deepseek-v2-lite-16b", 8), ("deepseek-moe-16b", 8),
             ("gemma2-9b", 8), ("qwen2-vl-7b", 8),
             ("jamba-1.5-large-398b", "reduced"))
SUB_BATCH, SUB_PROMPT, SUB_NEW = 4, 512, 16
SUB_TREE_THREADS = 3         # host threads drawing the golden cells' trees
SUB_MARGIN = 1e-4            # MoE routing compared above this top-k margin
# (c): gemma2-9b's decode step at SUB_BATCH x (SUB_PROMPT + SUB_NEW) keys
SOFTCAP_DECODE = dict(b=SUB_BATCH, h=16, kvh=8, hd=256,
                      t=SUB_PROMPT + SUB_NEW, cap=50.0)


def attention_layers(model) -> tuple:
    """(decoder self-attention layers, of them MLA (absorbed decode, no
    decode kernel), cross-attention blocks, encoder layers) of a model."""
    cfg = model.cfg
    attn = sum(s.mixer == "attn" for s in model.specs)
    cross = sum("xattn" in layer for layer in model.layers)
    return attn, attn if cfg.mla else 0, cross, len(model.encoder_layers)


def want_launches(model, prefills: int, steps: int) -> dict:
    """The attention launches a run of ``prefills`` prefills and ``steps``
    decode steps makes: flash for each self-attention, encoder and cross
    layer a prefill and each cross layer a step, decode for each non-MLA
    self-attention layer a step.  In a bf16 model each of them runs the bf16
    tensor-core kernel, ``flash_kernel_bf16`` (``flash_attention_bf16``)
    and, where the heads allow it, ``decode_partial_kernel_tc``
    (``decode_attention_tc``)."""
    from repro_torch.kernels import attention as att
    attn, mla, cross, enc = attention_layers(model)
    flash = prefills * (attn + enc + cross) + steps * cross
    decode = steps * (attn - mla)
    cfg = model.cfg
    bf16 = model.dtype == torch.bfloat16
    q = torch.empty((1, cfg.num_heads, cfg.resolved_head_dim),
                    dtype=model.dtype, device="meta")
    tc = bf16 and att.decode_on_tensor_cores(q, cfg.num_kv_heads)
    return att_want(att, flash_attention=flash, decode_attention=decode,
                    flash_attention_bf16=flash if bf16 else 0,
                    decode_attention_tc=decode if tc else 0)


class RoutingTap:
    """While entered, records each MoE call of the port
    (``models.moe.route``): every token's top-k experts (sorted), its
    top-k margin and the dropped pairs per expert, as
    ``tests/test_torch_golden_substrates.py`` stores the reference's."""

    def __init__(self, moe):
        self.moe, self.records = moe, []

    def __enter__(self):
        self.route = self.moe.route

        def route(p, x2, cfg):
            r = self.route(p, x2, cfg)
            k = cfg.top_k
            g = torch.sort(r.gates.double(), dim=-1, descending=True).values
            self.records.append({
                "experts": torch.sort(r.expert.reshape(-1, k), -1).values
                .cpu().numpy(),
                "margin": (g[:, k - 1] - g[:, k]).cpu().numpy(),
                "drops": torch.bincount(r.expert[~r.keep], minlength=cfg
                                        .num_experts).tolist()})
            return r
        self.moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def check_routing(got: list, want: list, ctx: str) -> dict:
    """``tests/test_torch_golden_substrates.py``'s check: each token's
    expert set equal where the reference's top-k margin exceeds
    SUB_MARGIN; drops per expert equal in a call with no near tie (near
    ties and the calls whose drops differ beside one are counted)."""
    if len(got) != len(want):
        fail(f"{ctx}: {len(got)} MoE calls, golden {len(want)}")
    out = {"tokens": 0, "near_ties": 0, "drops_differ_near_a_tie": 0}
    for c, (g, w) in enumerate(zip(got, want)):
        ge, we = g["experts"], np.asarray(w["experts"])
        if ge.shape != we.shape:
            fail(f"{ctx} call {c}: routing {ge.shape}, golden {we.shape}")
        sure = np.asarray(w["margin"]) > SUB_MARGIN
        out["tokens"] += int(sure.sum())
        out["near_ties"] += int((~sure).sum())
        bad = np.nonzero(sure & (ge != we).any(-1))[0]
        if len(bad):
            fail(f"{ctx} call {c}: token {int(bad[0])} routed to "
                 f"{ge[bad[0]].tolist()}, golden {we[bad[0]].tolist()}")
        if g["drops"] != w["drops"]:
            if sure.all():
                fail(f"{ctx} call {c}: drops {g['drops']}, golden "
                     f"{w['drops']}")
            out["drops_differ_near_a_tie"] += 1
    return out


def golden_cell_inputs(cfg, common: dict) -> dict:
    """``tests/test_torch_golden_substrates.py``'s ``cell_inputs``."""
    rng = np.random.default_rng(common["input_seed"])
    b, s = common["batch"], common["prompt"]
    out = {"prompts": rng.integers(0, cfg.vocab_size, (b, s)).astype(
               np.int32),
           "teacher": rng.integers(0, cfg.vocab_size, (common["steps"], b)
                                   ).astype(np.int32)}
    if cfg.is_encdec:
        out["frame_embeds"] = rng.standard_normal(
            (b, common["frames"], cfg.d_model), np.float32)
    if cfg.mrope_sections is not None:
        p = common["patches"]
        out["patch_embeds"] = 0.1 * rng.standard_normal((b, p, cfg.d_model),
                                                        np.float32)
        t = np.tile(np.arange(s, dtype=np.int32), (b, 1))
        h = np.where(t < p, t // 4, t - p + 2)
        w = np.where(t < p, t % 4, t - p + 4)
        out["positions"] = np.stack([t, h, w]).astype(np.int32)
    return out


def golden_substrate_cell(env: Env, arch: str, cell: dict, common: dict,
                          tree: dict, dev) -> dict:
    """(a) one golden cell on the card: prefill, the teacher-forced steps
    and (M-RoPE) the forward rows held to the reference's summaries, the
    MoE routing to the reference's."""
    cfg = dataclasses.replace(env.configs.get(arch), **cell["config"])
    if cfg.param_count()[0] != cell["params"]:
        fail(f"golden {arch}: {cfg.param_count()[0]} parameters, golden "
             f"{cell['params']}")
    t0 = time.perf_counter()
    model = env.models.LM(cfg, device=dev)
    env.models.params_from_numpy(model, tree)
    inputs = golden_cell_inputs(cfg, common)
    batch = {"tokens": torch.from_numpy(inputs["prompts"]).to(dev)}
    for k in ("frame_embeds", "patch_embeds"):
        if k in inputs:
            batch[k] = torch.from_numpy(inputs[k]).to(dev)
    s = common["prompt"]
    with RoutingTap(env.models.moe) as tap:
        caches = model.init_caches(common["batch"], s + common["steps"])
        logits, caches = model.prefill(batch, caches)
        rows = [logits]
        for t, tok in enumerate(inputs["teacher"]):
            logits, caches = model.decode_step(
                torch.from_numpy(tok).to(dev), caches, s + t)
            rows.append(logits)
    rows = torch.cat(rows).float().cpu().numpy()
    if rows.shape != (len(cell["rows"]), cfg.padded_vocab()) or \
            not np.isfinite(rows).all():
        fail(f"golden {arch}: logits {rows.shape} not finite or not of the "
             f"golden's shape")
    out = {"params": cell["params"], "rows": len(rows),
           "err": check_golden_rows(rows, cell["rows"])}
    if cell["routing"]:
        out["routing"] = check_routing(tap.records, cell["routing"],
                                       f"golden {arch}")
    if "forward_rows" in cell:
        batch["positions"] = torch.from_numpy(inputs["positions"]).to(dev)
        fwd = model(batch)[:, common["forward_rows"]]
        out["forward_err"] = check_golden_rows(
            fwd.float().cpu().numpy().reshape(-1, fwd.shape[-1]),
            cell["forward_rows"])
    out["s"] = time.perf_counter() - t0
    del model, caches
    torch.cuda.empty_cache()
    return out


def serve_family(env: Env, arch: str, depth, rng, dev) -> dict:
    """(b) one family served by ``Engine`` at full width, weights drawn on
    the card: a round of SUB_BATCH prompts of SUB_PROMPT random tokens and
    SUB_NEW new tokens, the same round again (pages reused), then on
    ``Engine(morpheus=False)``; the tokens of the three must agree, and
    each round's attention launches be the model's."""
    att, se = env.att, env.serving
    cfg = env.configs.get(arch)
    if depth == "reduced":
        cfg = cfg.reduced()
    elif depth is not None:
        cfg = dataclasses.replace(cfg, name=f"{cfg.name}-{depth}l",
                                  num_layers=depth)
    t0 = time.perf_counter()
    model = env.models.LM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_gb = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 1e9
    prompts = rng.integers(0, cfg.vocab_size, (SUB_BATCH, SUB_PROMPT))
    max_len = SUB_PROMPT + SUB_NEW
    eng = se.Engine(model, max_len=max_len)
    rounds = [("round 1", eng), ("round 2", eng),
              ("morpheus off", se.Engine(model, max_len=max_len,
                                         morpheus=False))]
    results = []
    with StepTimer(model) as timer:
        for name, e in rounds:
            reqs = [se.Request(i, p.tolist(), SUB_NEW)
                    for i, p in enumerate(prompts)]
            before = dict(att.launches)
            reused = e.pages_reused
            timer.reset()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rep = e.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            got = {k: att.launches[k] - before[k] for k in before}
            want = want_launches(model, 1, rep.steps)
            if got != want:
                fail(f"serving {cfg.name} {name}: attention launches {got}, "
                     f"expected {want}")
            results.append(dict(
                round=name, wall_s=wall, prefill_s=timer.prefill_s,
                decode_ms_step=1e3 * timer.decode_s / max(timer.steps, 1),
                steps=rep.steps, tokens_per_s=rep.generated / wall,
                pages_reused=e.pages_reused - reused, launches=got,
                tokens=[r.out_tokens for r in reqs]))
    toks = [r.pop("tokens") for r in results]
    vocab = cfg.padded_vocab()
    if any(len(t) != SUB_NEW or min(t) < 0 or max(t) >= vocab
           for t in toks[0]):
        fail(f"serving {cfg.name}: tokens out of range or short")
    if not toks[0] == toks[1] == toks[2]:
        fail(f"serving {cfg.name}: tokens differ across round 1, round 2 "
             f"and Morpheus off")
    if results[1]["pages_reused"] == 0:
        fail(f"serving {cfg.name}: round 2 reused no page")
    out = dict(arch=cfg.name, layers=len(model.layers),
               encoder_layers=len(model.encoder_layers), d_model=cfg.d_model,
               params=n_params, weight_gb=weight_gb, init_s=init_s,
               dtype=str(model.dtype).replace("torch.", ""), rounds=results)
    del model, eng, rounds
    torch.cuda.empty_cache()
    return out


def softcap_decode(env: Env, dev) -> dict:
    """(c) the soft-capped decode kernel against its plain version at
    gemma2-9b's serving shape, f32 and bf16, timed with its bound; SDPA
    takes no soft cap, so no library time."""
    att = env.att
    c = SOFTCAP_DECODE
    rng = np.random.default_rng(5)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).replace("torch.", "")
        args = (att_randn(rng, (c["b"], c["h"], c["hd"]), dt, dev),
                att_randn(rng, (c["b"], c["t"], c["kvh"], c["hd"]), dt, dev),
                att_randn(rng, (c["b"], c["t"], c["kvh"], c["hd"]), dt, dev),
                torch.from_numpy(rng.random((c["b"], c["t"])) < 0.9).to(dev))
        kw = {"softcap": c["cap"]}
        err = att_close(att.decode_attention(*args, **kw),
                        att.decode_attention_plain(*args, **kw),
                        att_tol("decode_attention", dt),
                        f"soft-capped decode {tag}")
        out[tag] = dict(err=err, shape=[list(a.shape) for a in args],
                        **times(lambda: att.decode_attention(*args, **kw),
                                lambda: att.decode_attention_plain(*args,
                                                                   **kw),
                                20, 3),
                        bound=attention_bound("decode_attention", args, kw))
    return out


def phase_substrates(env: Env, dev) -> dict:
    """Phase 16: every model family on the card.  (c) the soft-capped
    decode kernel; (b) each family served by ``Engine`` with every
    attention count set to 0 before and read after, its calls then
    replayed against the plain versions; (a) the golden cells of
    ``tests/data/torch_golden_substrates.json``, whose trees host threads
    draw meanwhile."""
    att = env.att
    golden = json.loads(GOLDEN_SUBSTRATES.read_text())
    common = golden["common"]
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(SUB_TREE_THREADS)
    trees = {arch: pool.submit(
        env.models.seeded_numpy_params,
        dataclasses.replace(env.configs.get(arch), **cell["config"]),
        common["seed"]) for arch, cell in golden["cells"].items()}

    softcap = softcap_decode(env, dev)

    rng = np.random.default_rng(0)
    with PathCalls(env.ops, ATT_WRAPPERS) as calls:
        torch.cuda.synchronize()
        att.reset_launches()
        served = [serve_family(env, arch, depth, rng, dev)
                  for arch, depth in SUB_SERVE]
        torch.cuda.synchronize()
        counts, plain = dict(att.launches), dict(att.plain_runs)
    if any(plain.values()):
        fail(f"substrates: plain versions ran {plain}")
    if any(counts[k] for k in counts
           if k not in ("decode_attention", "flash_attention")):
        fail(f"substrates: serving launched the flash backward or an "
             f"option of tensor parallelism {counts}")
    counts = {k: counts[k] for k in ("decode_attention", "flash_attention")}
    if any(v <= 0 for v in counts.values()):
        fail(f"substrates: an attention kernel was not launched {counts}")
    serve_s = time.perf_counter() - t0
    path = phase_attention_path(env, calls, "phase 16: the families' "
                                "serving path")

    cells = {}
    for arch, cell in golden["cells"].items():
        tree = trees.pop(arch).result()
        cells[arch] = golden_substrate_cell(env, arch, cell, common, tree,
                                            dev)
        del tree
    pool.shutdown()
    wall = time.perf_counter() - t0
    log("phase 16: golden cells (full width, 2 decoder layers) on the card "
        "match the reference's: " + "; ".join(
            f"{a}: {c['params']} parameters, {c['rows']} rows, max abs err "
            f"{c['err']:.3g}"
            + (f", forward rows max abs err {c['forward_err']:.3g}"
               if "forward_err" in c else "")
            + (f", MoE routing equal on {c['routing']['tokens']} tokens "
               f"({c['routing']['near_ties']} near ties not compared, "
               f"{c['routing']['drops_differ_near_a_tie']} calls whose drops "
               f"differ beside one)" if "routing" in c else "")
            + f", {c['s']:.1f} s" for a, c in cells.items()))
    log("phase 16: serving every family by Engine (" + f"{SUB_BATCH} x "
        f"{SUB_PROMPT}-token prompts, {SUB_NEW} new tokens; round 1, round "
        f"2, Morpheus off give the same tokens): " + "; ".join(
            f"{s['arch']} ({s['layers']} layers"
            + (f" + {s['encoder_layers']} encoder" if s["encoder_layers"]
               else "")
            + f", d_model {s['d_model']}, {s['params']} parameters, "
            f"{s['weight_gb']:.2f} GB {s['dtype']}, drawn in "
            f"{s['init_s']:.2f} s): " + ", ".join(
                f"{r['round']} prefill {r['prefill_s']:.3f} s, decode "
                f"{r['decode_ms_step']:.2f} ms a step x {r['steps']}, "
                f"{r['tokens_per_s']:.1f} tokens/s, launches "
                f"{json.dumps(r['launches'])}" for r in s["rounds"])
            for s in served)
        + f"; attention launches {json.dumps(counts)}, plain runs 0")
    log("phase 16: soft-capped decode (gemma2-9b, B "
        f"{SOFTCAP_DECODE['b']}, H {SOFTCAP_DECODE['h']}/"
        f"{SOFTCAP_DECODE['kvh']}, hd {SOFTCAP_DECODE['hd']}, T "
        f"{SOFTCAP_DECODE['t']}, cap {SOFTCAP_DECODE['cap']}) == plain: "
        + "; ".join(f"{k}: max abs err {v['err']:.3g}, {v['ms']:.4f} ms on "
                    f"the card, plain {v['plain_ms']:.4f} ms, bound "
                    f"{v['bound'][0]:.4f} ms ({v['bound'][1]}), SDPA none "
                    f"(no soft cap)" for k, v in softcap.items())
        + f"; phase {wall:.1f} s ({serve_s:.1f} s to the end of serving)")
    return {"launches": counts, "served": served, "cells": cells,
            "softcap": softcap, "path": path, "wall_s": wall}


# ------------------------------------------------------ flash backward

# (atol, rtol) of the flash backward by input dtype: f32 the flash
# forward's bound; bf16 from the card's measured error (7.8e-3 of |plain|
# at the serving shape) with twice the room, under the reference's 3e-2
BWD_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2e-3, 1.6e-2)}
# absolute error of the forward's base-2 log-sum-exp (|lse| ~ 10-20 here):
# f32 a few ulps; bf16 inputs are exact in f32, but the tensor cores sum
# the products in another order
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
BWD_PROFILED = 3             # backward calls in the profiled window
# profiled windows tried before "not measured": late in the whole script
# the profiler drops a short window's kernels as out of its range (its
# KINETO_LOG_LEVEL=0 log) in about half the windows, all of them or only
# some (a window with the dK/dV kernels and no dQ kernel), so a window
# counts only when it holds both kernels
BWD_WINDOWS = 10
BWD_PARTS = (("dq_ms", "bwd_dq_"), ("dkdv_ms", "bwd_dkdv_"))
BWD_TRAINING = "training f32 B8 S=T128 H32/8"
# The device ms of the backward before its Hopper redesign, quoted from
# PERF.md (kernel table: NVIDIA H100 80GB HBM3 at 700 W) by phase-17
# label, for the log only: the kernels line carries this run's numbers
# alone
BWD_BEFORE_MS = {
    BWD_TRAINING: 0.7787, "serving f32 B8 S=T1024 H32/8": 24.39,
    "serving bf16 B8 S=T1024 H32/8": 24.85,
    "MLA f32 B4 S=T512 H16 hd192/128": 4.581,
    "gemma2 f32 B2 S=T1024 H16/8 hd256 window256 cap50": 4.862,
    "cross f32 B4 S256 T384 H16/16 hd64": 0.4517}
BWD_CASES = (  # label, (b, s, t, h, kv, hd, hdv), causal, window, cap, dtype
    (BWD_TRAINING, (8, 128, 128, 32, 8, 128, 128), True, 0, 0.0,
     torch.float32),
    ("serving f32 B8 S=T1024 H32/8", (8, 1024, 1024, 32, 8, 128, 128), True,
     0, 0.0, torch.float32),
    ("serving bf16 B8 S=T1024 H32/8", (8, 1024, 1024, 32, 8, 128, 128),
     True, 0, 0.0, torch.bfloat16),
    ("MLA f32 B4 S=T512 H16 hd192/128", (4, 512, 512, 16, 16, 192, 128),
     True, 0, 0.0, torch.float32),
    ("gemma2 f32 B2 S=T1024 H16/8 hd256 window256 cap50",
     (2, 1024, 1024, 16, 8, 256, 256), True, 256, 50.0, torch.float32),
    ("cross f32 B4 S256 T384 H16/16 hd64", (4, 256, 384, 16, 16, 64, 64),
     False, 0, 0.0, torch.float32))


def bwd_bound(q, k, v, kw) -> tuple:
    """Least time of one backward (``kernel_work.flash_backward_work``: q,
    k, v, the output and its gradient read once and dq, dk, dv written
    once, against 2.5 times the forward's FLOPs)."""
    work = kernel_work()
    return work.bound_ms(work.flash_backward_work(q, k, v, kw))


def sdpa_backward(q, k, v, do, kw):
    """One ``torch.autograd.grad`` through
    ``scaled_dot_product_attention`` on the same inputs (heads moved to dim
    1 beforehand, the forward run once), timed as the library's time and
    never called by the port; None for a soft cap, which SDPA does not
    take."""
    if kw["softcap"]:
        return None
    args = [a.transpose(1, 2).contiguous().requires_grad_(True)
            for a in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    s, t = q.shape[1], k.shape[1]
    mask = None
    q_start = kw.get("q_start", 0)
    if kw["window"] or q_start or (kw["causal"] and s != t):
        i = torch.arange(q_start, q_start + s, device=q.device)[:, None]
        j = torch.arange(t, device=q.device)[None, :]
        mask = (j <= i) if kw["causal"] else torch.ones_like(i - j,
                                                             dtype=bool)
        if kw["window"]:
            mask = mask & (i - j < kw["window"])
    out = sdpa(*args, attn_mask=mask,
               is_causal=kw["causal"] and mask is None, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, args, dot, retain_graph=True)


def bwd_split(run) -> dict:
    """Device ms a call of the dQ and the dK/dV kernel, from one
    ``torch.profiler`` window of ``BWD_PROFILED`` calls of ``run``, and
    the windows it took: up to ``BWD_WINDOWS`` while a window lacks either
    kernel (if all do, the times are None, not measured).  The launch
    counts, not this window, show that the kernels ran."""
    for tries in range(1, BWD_WINDOWS + 1):
        _, us = profiled(lambda: [run() for _ in range(BWD_PROFILED)])
        hits = {part: [t for name, t in us.items() if key in name]
                for part, key in BWD_PARTS}
        if all(hits.values()):
            return {"split_windows": tries} | {
                part: sum(h) / 1e3 / BWD_PROFILED
                for part, h in hits.items()}
        if us:
            log(f"flash backward: profiled window {tries} holds "
                f"{sorted(us)}, not both kernels")
    return {"split_windows": None} | {part: None for part, _ in BWD_PARTS}


def ms_text(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def phase_flash_backward(env: Env, dev) -> dict:
    """Phase 17: the flash backward kernels against their plain version on
    the card at the training shape, the serving shape (f32 and bf16),
    MLA's head dims, gemma2's window and soft cap and a cross-attention
    shape, reading the log-sum-exp the forward kept (held to the plain
    one); device ms by CUDA-graph replay and of each kernel by the
    profiler, the forward with and without its log-sum-exp, the bound,
    and the backward of SDPA through autograd as the library's time."""
    att = env.att
    rng = np.random.default_rng(0)
    out = {"err": 0.0, "lse_err": 0.0, "cases": {}}
    for label, (b, s, t, h, kv, hd, hdv), causal, window, cap, dt in \
            BWD_CASES:
        q = att_randn(rng, (b, s, h, hd), dt, dev)
        k = att_randn(rng, (b, t, kv, hd), dt, dev)
        v = att_randn(rng, (b, t, kv, hdv), dt, dev)
        kw = dict(causal=causal, window=window, softcap=cap)
        o, lse = att.flash_attention_with_lse(q, k, v, **kw)
        want_lse = att.flash_lse_plain(q, k, **kw)
        keyed = want_lse > -1e30             # rows with a valid key
        lse_err = float((lse - want_lse)[keyed].abs().max())
        if not lse_err <= LSE_TOL[dt]:
            fail(f"flash backward {label}: the forward's log-sum-exp is "
                 f"{lse_err:.3g} from plain (tolerance {LSE_TOL[dt]})")
        del want_lse, keyed
        do = att_randn(rng, tuple(o.shape), dt, dev)
        got = att.flash_attention_backward(q, k, v, o, do, lse, **kw)
        want = att.flash_attention_backward_plain(q, k, v, o, do, **kw)
        err = max(att_close(g, w, BWD_TOL[dt], f"flash backward {label} {n}")
                  for g, w, n in zip(got, want, ("dq", "dk", "dv")))
        for g, x in zip(got, (q, k, v)):
            if g.dtype != dt or g.shape != x.shape:
                fail(f"flash backward {label}: a gradient of "
                     f"{tuple(g.shape)} {g.dtype}")
        del got, want
        library = sdpa_backward(q, k, v, do, kw)

        def kernel():
            return att.flash_attention_backward(q, k, v, o, do, lse, **kw)
        t_ = times(kernel,
                   lambda: att.flash_attention_backward_plain(q, k, v, o, do,
                                                              **kw),
                   5, 2)
        t_["library_ms"] = timed_cuda(library, 5) if library else None
        out["cases"][label] = dict(
            shape=[[b, s, h, hd], [b, t, kv, hd], [b, t, kv, hdv]],
            dtype=str(dt).replace("torch.", ""), kwargs=kw, err=err,
            lse_err=lse_err, **t_, **bwd_split(kernel),
            forward_ms=device_ms(lambda: att.flash_attention(q, k, v, **kw),
                                 5),
            forward_lse_ms=device_ms(
                lambda: att.flash_attention_with_lse(q, k, v, **kw), 5),
            bound=bwd_bound(q, k, v, kw))
        out["err"] = max(out["err"], err)
        out["lse_err"] = max(out["lse_err"], lse_err)
        del q, k, v, o, lse, do, library
        torch.cuda.empty_cache()
    log("phase 17: flash backward kernels == plain within " + "; ".join(
        f"{str(d)[6:]} (atol, rtol) {tol}" for d, tol in BWD_TOL.items())
        + ", the forward's log-sum-exp within " + "; ".join(
            f"{str(d)[6:]} {tol}" for d, tol in LSE_TOL.items()) + ": "
        + "; ".join(
            f"{k}: max abs err {c['err']:.3g} (log-sum-exp "
            f"{c['lse_err']:.3g}), {c['ms']:.4f} ms on the card "
            f"({c['call_ms']:.4f} ms a call; dQ {ms_text(c['dq_ms'])} + "
            f"dK/dV {ms_text(c['dkdv_ms'])} ms profiled, "
            + (f"{BWD_WINDOWS} windows without both kernels"
               if c["split_windows"] is None
               else f"window {c['split_windows']} of {BWD_WINDOWS}")
            + "; the forward "
            f"{c['forward_ms']:.4f} ms, with its log-sum-exp "
            f"{c['forward_lse_ms']:.4f}), plain {c['plain_ms']:.4f} ms, "
            "SDPA's backward "
            + ("none (no soft cap)" if c["library_ms"] is None
               else f"{c['library_ms']:.4f} ms")
            + f", bound {c['bound'][0]:.4f} ms ({c['bound'][1]})"
            for k, c in out["cases"].items()))
    log("phase 17: before the Hopper redesign, quoted from PERF.md and not "
        "measured in this run: " + "; ".join(
            f"{k}: {ms} ms" for k, ms in BWD_BEFORE_MS.items()))
    return out


# ------------------------------------------------------------- training

TRAIN_ARCH = "qwen3-4b"
TRAIN_LAYERS = 8                 # of 36: 1.2 B parameters, ~24 GB of state
# one checkpoint of the 8-layer state (parameters and both AdamW moments
# in f32) is 14.4 GB, so the phase keeps its disk writes to two: the 24
# steps checkpoint once, at their end, and the resumed run at step 30
TRAIN_STEPS, TRAIN_RESUME, TRAIN_CKPT_EVERY = 24, 30, 24
TRAIN_BATCH, TRAIN_SEQ = 8, 128  # the launcher's defaults
TRAIN_REPEAT_STEPS = 4
TRAIN_CKPT = ROOT / "build" / "chip_smoke_train"
GOLDEN_TRAIN_THREADS = 3


def grad_summary(env: Env, state, grads, want: dict) -> dict:
    """Each leaf's gradient norm and its entries at the golden's flat
    indices (the reference's stacked order), on the card."""
    out = {}
    tree = env.pytree.from_parts(state.params, grads)
    for path, leaf in env.pytree.flatten(tree):
        flat = torch.cat([p.reshape(-1) for p in leaf.parts]).float()
        idx = torch.tensor(want["leaves"][path]["idx"], device=flat.device)
        out[path] = {"norm": float(torch.linalg.vector_norm(flat.double())),
                     "idx": want["leaves"][path]["idx"],
                     "vals": flat[idx].tolist()}
    return out


def golden_train_cell(env: Env, arch: str, want: dict, common: dict, tree,
                      dev) -> dict:
    """One cell of ``tests/data/torch_golden_train.json`` on the card: the
    step-0 loss and gradients through the kernels, then three AdamW steps
    on the same batch."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(env.configs.get(arch),
                              name=f"{arch}-{common['num_layers']}l",
                              num_layers=common["num_layers"])
    model = env.models.LM(cfg, device=dev)
    opt = env.optim.AdamW(learning_rate=common["learning_rate"])
    state = env.train_step.init_state(model, opt, tree)
    # the reference's batch, kept in the file (the pipeline's Zipf draws
    # differ between numpy versions)
    batch = {k: torch.tensor(v, dtype=torch.int64, device=dev)
             for k, v in want["batch"].items()}
    flat = env.pytree.parts(state.params)
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, flat)]
    gnorm = float(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                 for g in grads)))
    got = {"grad_norm": gnorm, "leaves": grad_summary(env, state, grads,
                                                      want)}
    del grads, loss
    step = env.train_step.make_train_step(model, opt)
    got["loss"] = []
    for _ in range(common["steps"]):
        state, met = step(state, batch)
        got["loss"].append(float(met["loss"]))
    err = check_train_cell(got, want, arch)
    del model, state, step
    torch.cuda.empty_cache()
    return {"params": sum(p.numel() for p in flat), "err": err,
            "loss": got["loss"], "want_loss": want["loss"],
            "s": time.perf_counter() - t0}


def check_train_cell(got: dict, want: dict, ctx: str) -> dict:
    """The card's numbers against the reference's: the step-0 loss within
    1e-4 relative, the losses after AdamW steps 1 and 2 within 1e-3,
    ``grad_norm`` and each leaf's norm within 1e-3 relative and each kept
    entry within 1e-3 of its leaf's norm."""
    err = {"loss": abs(got["loss"][0] - want["loss"][0])
           / abs(want["loss"][0]),
           "steps": max(abs(a - b) / abs(b) for a, b in
                        zip(got["loss"][1:], want["loss"][1:])),
           "grad_norm": abs(got["grad_norm"] - want["grad_norm"])
           / want["grad_norm"], "leaf_norm": 0.0, "entries": 0.0}
    if err["loss"] > 1e-4 or err["steps"] > 1e-3 or err["grad_norm"] > 1e-3:
        fail(f"golden training {ctx}: losses {got['loss']} (reference "
             f"{want['loss']}), grad_norm {got['grad_norm']} (reference "
             f"{want['grad_norm']})")
    if sorted(got["leaves"]) != sorted(want["leaves"]):
        fail(f"golden training {ctx}: leaf paths differ")
    for path, w in want["leaves"].items():
        g = got["leaves"][path]
        scale = max(w["norm"], 1e-30)
        e = abs(g["norm"] - w["norm"]) / scale
        d = float(np.max(np.abs(np.subtract(g["vals"], w["vals"])))) / scale
        if not (np.isfinite(g["vals"]).all() and e <= 1e-3 and d <= 1e-3):
            fail(f"golden training {ctx} {path}: norm {g['norm']} "
                 f"(reference {w['norm']}), entries off by {d:.3g} of the "
                 f"norm")
        err["leaf_norm"] = max(err["leaf_norm"], e)
        err["entries"] = max(err["entries"], d)
    return err


class StepClock:
    """A ``print_fn`` for ``train.loop.train`` with ``log_every=1``: the
    host time of each step's end (the loop reads each loss back, so the
    card is done with the step)."""

    def __init__(self):
        self.marks = [time.perf_counter()]

    def __call__(self, line: str) -> None:
        self.marks.append(time.perf_counter())

    def step_ms(self) -> list:
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]


def train_run(env: Env, cfg, dev, steps: int, **kw) -> tuple:
    """(losses, supervisor report, ms of each step, ms after the last
    step: the supervisor's final checkpoint) of one ``train`` call."""
    clock = StepClock()
    state, losses, rep = env.train_loop.train(
        cfg, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ, device=dev,
        log_every=1, print_fn=clock, **kw)
    tail_ms = 1e3 * (time.perf_counter() - clock.marks[-1])
    if not all(math.isfinite(x) for x in losses):
        fail(f"training: a loss is not finite {losses}")
    del state
    return losses, rep, clock.step_ms(), tail_ms


def phase_training(env: Env, dev) -> dict:
    """Phase 18: training on the card.  (a) the golden cells of
    ``tests/data/torch_golden_train.json``, whose trees host threads draw
    meanwhile; (b) qwen3-4b at full width, 8 layers, through
    ``train.loop.train`` with the attention counts set to 0 before and read
    after: 24 steps with checkpoints every 8, resumed to 30; then runs of
    4 steps twice each, plain, with the int8 compressor and with 2
    microbatches."""
    att = env.att
    golden = json.loads(GOLDEN_TRAIN.read_text())
    common = golden["common"]
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(GOLDEN_TRAIN_THREADS)
    trees = {arch: pool.submit(
        env.models.seeded_numpy_params, dataclasses.replace(
            env.configs.get(arch), num_layers=common["num_layers"]),
        common["seed"]) for arch in golden["cells"]}

    cfg = train_config(env)
    import shutil
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    free_gb = shutil.disk_usage(ROOT).free / 1e9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    att.reset_launches()
    losses, rep, ms, save_ms = train_run(env, cfg, dev, TRAIN_STEPS,
                                         ckpt_dir=str(TRAIN_CKPT),
                                         ckpt_every=TRAIN_CKPT_EVERY)
    losses2, rep2, ms2, _ = train_run(env, cfg, dev, TRAIN_RESUME,
                                      ckpt_dir=str(TRAIN_CKPT),
                                      ckpt_every=TRAIN_CKPT_EVERY)
    torch.cuda.synchronize()
    counts, plain = dict(att.launches), dict(att.plain_runs)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    ckpt_gb = sum(f.stat().st_size for f in TRAIN_CKPT.rglob("*.npy")) / 1e9
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    steps = TRAIN_RESUME
    want = att_want(att, flash_attention=2 * TRAIN_LAYERS * steps,
                    flash_attention_backward=TRAIN_LAYERS * steps)  # remat
    if counts != want or any(plain.values()):
        fail(f"training: attention launches {counts} (expected {want}), "
             f"plain runs {plain}")
    if not (rep.steps_run == TRAIN_STEPS and rep.restarts == 0
            and rep2.resumed_from == TRAIN_STEPS and rep2.restarts == 0
            and rep2.steps_run == TRAIN_RESUME - TRAIN_STEPS):
        fail(f"training: supervisor reports {rep} then {rep2}")
    head, tail = np.mean(losses[:4]), np.mean(losses[-4:])
    if not tail < head:
        fail(f"training: the loss did not fall ({losses})")
    step_ms = float(np.median(ms[1:]))
    params = cfg.param_count()[0]

    repeats = {}
    for name, kw in (("plain", {}), ("int8", {"grad_compression": True}),
                     ("microbatches2", {"microbatches": 2})):
        runs = [train_run(env, cfg, dev, TRAIN_REPEAT_STEPS, seed=1,
                          **kw)[0] for _ in range(2)]
        d = float(np.max(np.abs(np.subtract(runs[0], runs[1]))
                         / np.abs(runs[1])))
        if d > 1e-5:
            fail(f"training {name}: two runs differ by {d:.3g} ({runs})")
        repeats[name] = {"losses": runs[0], "rel_diff": d}
        torch.cuda.empty_cache()
    train_s = time.perf_counter() - t0

    cells = {}
    for arch, cell in golden["cells"].items():
        tree = trees.pop(arch).result()
        cells[arch] = golden_train_cell(env, arch, cell, common, tree, dev)
        del tree
    pool.shutdown()
    log("phase 18: golden training cells (full width, 2 decoder layers) on "
        "the card match the reference's: " + "; ".join(
            f"{a}: {c['params']} parameters, losses {c['loss']} (reference "
            f"{c['want_loss']}), rel err loss {c['err']['loss']:.3g}, steps "
            f"{c['err']['steps']:.3g}, grad_norm {c['err']['grad_norm']:.3g}"
            f", leaf norms {c['err']['leaf_norm']:.3g}, entries "
            f"{c['err']['entries']:.3g}, {c['s']:.1f} s"
            for a, c in cells.items()))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"phase 18: {cfg.name} ({params} parameters, f32) trained by "
        f"train.loop.train, batch {TRAIN_BATCH} x {TRAIN_SEQ}: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} over {TRAIN_STEPS} steps, "
        f"resumed from step {rep2.resumed_from} to {TRAIN_RESUME} (loss "
        f"{losses2[-1]:.4f}), restarts 0; {step_ms:.1f} ms a step (median "
        f"of steps 2-{TRAIN_STEPS}, the host clock between the loss "
        f"read-backs), {tokens / step_ms * 1e3:.0f} tokens/s; the first "
        f"step {ms[0]:.0f} ms with the model's set-up, the checkpoint at "
        f"step {TRAIN_STEPS} {save_ms:.0f} ms, the resumed run's restore "
        f"and first step {ms2[0]:.0f} ms; peak memory {peak_gb:.2f} GB, "
        f"{ckpt_gb:.1f} GB of checkpoints ({free_gb:.0f} GB of disk free "
        f"before); attention launches "
        f"{json.dumps(counts)}, plain runs 0; repeated {TRAIN_REPEAT_STEPS}"
        "-step runs equal within 1e-5: " + ", ".join(
            f"{k} (max rel diff {v['rel_diff']:.3g})"
            for k, v in repeats.items())
        + f"; phase {time.perf_counter() - t0:.1f} s ({train_s:.1f} s to "
        "the end of training)")
    return {"launches": counts, "cells": cells, "step_ms": step_ms,
            "first_step_ms": ms[0], "save_ms": save_ms,
            "tokens_per_s": tokens / step_ms * 1e3, "peak_gb": peak_gb,
            "losses": losses, "params": params, "repeats": repeats}


# ------------------------------------------------------------- roofline

# (a): the dry run's cells of this arch; the whole 40-cell sweep on meta
# took 199 s of host time on a CPU where these four took about 10 s, past
# this phase's share of the script's limit
ROOFLINE_ARCH = "qwen3-4b"
ROOFLINE_PREFILLS = 2        # (b): prefills timed after a warm one
ROOFLINE_DECODES = 5         # (b): decode steps timed, all at one position


def count_equal(got, want, ctx: str) -> None:
    """Fail unless two counts (``op_cost.Cost``) agree exactly in FLOPs and
    bytes, naming the ops whose charges differ."""
    if got.flops == want.flops and got.bytes == want.bytes:
        return
    diff = {k: (got.by_name.get(k), want.by_name.get(k))
            for k in set(got.by_name) | set(want.by_name)
            if got.by_name.get(k) != want.by_name.get(k)}
    fail(f"{ctx}: the card's count ({got.flops} FLOPs, {got.bytes} bytes) "
         f"differs from meta's ({want.flops}, {want.bytes}): {diff}")


def host_and_events(fn, reps: int) -> tuple:
    """(median ms by CUDA events, median wall ms) of ``reps`` calls of
    ``fn()``, each synchronised before and after."""
    ev, wall = [], []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
        ev.append(e0.elapsed_time(e1))
    return float(np.median(ev)), float(np.median(wall))


def serving_roofline(env: Env, model, prompts: np.ndarray, max_len: int,
                     dev) -> dict:
    """Phase 20 (b), run inside phase 12 on its model (qwen3-4b at full
    width and depth, so no second 16 GB model is built): the prefill of
    ``prompts`` into fresh caches and one decode step at the next
    position, counted by the op counter on the card (through the kernels:
    one flash and one decode launch a layer, no plain run) and on
    ``meta``, FLOPs and bytes equal; then the same calls timed without
    the counter (CUDA events and wall clock)."""
    from repro_torch.launch import dryrun as D
    att = env.att
    cfg = model.cfg
    b, s = prompts.shape
    toks = torch.from_numpy(prompts.astype(np.int32)).to(dev)
    cur = torch.zeros((b,), dtype=torch.int32, device=dev)
    att.reset_launches()
    caches = model.init_caches(b, max_len)
    pre = D.count_prefill(model, {"tokens": toks}, caches)
    dec = D.count_decode(model, cur, caches, s)
    torch.cuda.synchronize()
    n = len(model.layers)
    want = att_want(att, decode_attention=n, flash_attention=n)
    if att.launches != want or any(att.plain_runs.values()):
        fail(f"phase 20: the counted steps launched {att.launches} "
             f"(expected {want}), plain runs {att.plain_runs}")
    meta = env.models.LM(cfg, device="meta")
    mc = meta.init_caches(b, max_len)
    mpre = D.count_prefill(meta, {"tokens": torch.empty(
        (b, s), dtype=torch.int32, device="meta")}, mc)
    mdec = D.count_decode(meta, torch.empty((b,), dtype=torch.int32,
                                            device="meta"), mc, s)
    count_equal(pre, mpre, "phase 20 prefill")
    count_equal(dec, mdec, "phase 20 decode")
    caches = model.init_caches(b, max_len)
    model.prefill({"tokens": toks}, caches)             # warm
    pre_ms, pre_wall = host_and_events(
        lambda: model.prefill({"tokens": toks}, caches), ROOFLINE_PREFILLS)
    dec_ms, dec_wall = host_and_events(
        lambda: model.decode_step(cur, caches, s), ROOFLINE_DECODES)
    del caches
    shape = env.configs.ShapeConfig
    return {"prefill": dict(cost=pre, meta=mpre, ms=pre_ms, wall_ms=pre_wall,
                            shape=shape("phase12", s, b, "prefill")),
            "decode": dict(cost=dec, meta=mdec, ms=dec_ms, wall_ms=dec_wall,
                           shape=shape("phase12", max_len, b, "decode"))}


def train_config(env: Env):
    """Phase 18's training config: qwen3-4b at full width, depth cut to
    ``TRAIN_LAYERS``."""
    return dataclasses.replace(env.configs.get(TRAIN_ARCH),
                               name=f"{TRAIN_ARCH}-{TRAIN_LAYERS}l",
                               num_layers=TRAIN_LAYERS)


def training_roofline(env: Env, dev) -> dict:
    """Phase 20 (c): one training step of phase 18's config and batch
    (AdamW with the loop's schedule, remat, the flash backward) counted on
    the card (through the kernels) and on ``meta``, FLOPs and bytes
    equal."""
    from repro_torch.launch import dryrun as D
    att, optim = env.att, env.optim
    cfg = train_config(env)
    shape = env.configs.ShapeConfig("phase18", TRAIN_SEQ, TRAIN_BATCH,
                                    "train")

    def opt():
        return optim.AdamW(learning_rate=3e-4,
                           schedule=optim.cosine_with_warmup(3, TRAIN_STEPS))

    def batch(device):
        size = (TRAIN_BATCH, TRAIN_SEQ)
        if torch.device(device).type == "meta":
            t = torch.empty(size, dtype=torch.int32, device=device)
        else:
            g = torch.Generator(device=device).manual_seed(0)
            t = torch.randint(0, cfg.vocab_size, size, generator=g,
                              device=device, dtype=torch.int32)
        return {"tokens": t, "targets": t}

    model = env.models.LM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(0))
    att.reset_launches()
    cost = D.count_train(model, batch(dev), opt())
    torch.cuda.synchronize()
    want = att_want(att, flash_attention=2 * TRAIN_LAYERS,
                    flash_attention_backward=TRAIN_LAYERS)
    if att.launches != want or any(att.plain_runs.values()):
        fail(f"phase 20: the counted training step launched "
             f"{att.launches} (expected {want}), plain runs "
             f"{att.plain_runs}")
    del model
    torch.cuda.empty_cache()
    meta = D.count_train(env.models.LM(cfg, device="meta"), batch("meta"),
                         opt())
    count_equal(cost, meta, "phase 20 training step")
    return {"cost": cost, "meta": meta, "cfg": cfg, "shape": shape}


def roofline_row(cfg, shape, cost, dtype, measured: dict) -> dict:
    """Bound, dominant term and, for each measured time (ms), the
    roofline fraction (bound / measured) and the model-FLOPs share
    (``model_flops / (measured x peak)``)."""
    from repro_torch.roofline import CHIP, model_flops, roofline_terms
    terms = roofline_terms(flops=cost.flops, bytes_hbm=cost.bytes,
                           bytes_collective=cost.collective_bytes, chips=1,
                           dtype=dtype)
    mflops = model_flops(cfg, shape)
    bound_ms = terms["bound_s"] * 1e3
    shares = {}
    for what, ms in measured.items():
        if ms is None:
            continue
        shares[what] = {"ms": ms, "fraction": bound_ms / ms,
                        "mfu": mflops / (ms / 1e3 * CHIP.peak_flops(dtype))}
    return {"flops": cost.flops, "bytes": cost.bytes, "bound_ms": bound_ms,
            "dominant": terms["dominant"],
            "t_compute_ms": terms["t_compute_s"] * 1e3,
            "t_memory_ms": terms["t_memory_s"] * 1e3,
            "model_flops": mflops, "shares": shares,
            "temp_gb": cost.temp_bytes / 1e9}


def phase_roofline(env: Env, dev, serving: dict, training: dict) -> dict:
    """Phase 20: (a) the one-device dry run on ``meta`` of
    ``ROOFLINE_ARCH``'s four cells; (b) phase 12's prefill and decode step
    (``serving_roofline``) and (c) phase 18's training step
    (``training_roofline``), each counted on the card equal to its
    ``meta`` count, set against their measured times: the bound, its
    dominant term, the roofline fraction and the model-FLOPs share, each
    in (0, 1] or the phase fails."""
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline import CHIP
    t0 = time.perf_counter()
    cells = []
    for arch, shape, skipped in env.configs.cells(include_skipped=True):
        if arch != ROOFLINE_ARCH:
            continue
        if skipped:
            cells.append({"arch": arch, "shape": shape, "skipped": True})
            continue
        rep = D.lower_cell(arch, shape)
        if not rep["ok"] or rep["hlo_flops_per_chip"] <= 0:
            fail(f"phase 20: dry run of {arch} x {shape} failed: {rep}")
        cells.append(rep)
    dry_s = time.perf_counter() - t0
    log(f"phase 20: (a) dry run on meta (one H100, datasheet constants: "
        f"{CHIP.peak_flops_f32 / 1e12:.0f} TFLOP/s f32, "
        f"{CHIP.peak_flops_bf16 / 1e12:.0f} bf16, "
        f"{CHIP.hbm_Bps / 1e12:.2f} TB/s, hbm_bytes {CHIP.hbm_bytes} "
        f"against this card's total_memory "
        f"{torch.cuda.get_device_properties(0).total_memory}) of "
        f"{ROOFLINE_ARCH}'s four cells in {dry_s:.1f} s (not the whole "
        f"40-cell sweep: 199 s on meta on a CPU where these took about "
        f"10 s): " + "; ".join(
            f"{c['shape']}: documented skip" if c.get("skipped") else
            f"{c['shape']}: {c['hlo_flops_per_chip']:.4g} FLOPs, "
            f"{c['hlo_bytes_per_chip']:.4g} bytes, bound "
            f"{c['bound_s'] * 1e3:.4g} ms ({c['dominant']}), "
            f"{c['bytes_per_chip'] / 1e9:.1f} GB a chip, fits {c['fits']}, "
            f"counted in {c['compile_s']} s" for c in cells))

    rows = {}
    sv = serving["roofline"]
    windows = {"prefill": serving["prefill_window"],
               "decode": serving["decode_window"]}
    cfg = env.configs.get(SERVE_ARCH)
    for kind in ("prefill", "decode"):
        r = sv[kind]
        w = windows[kind]
        rows[kind] = roofline_row(cfg, r["shape"], r["cost"], torch.float32, {
            "device_busy": w["device_busy_ms"] if w["measured"] else None,
            "events": r["ms"], "wall": r["wall_ms"]})
        rows[kind]["meta_temp_gb"] = r["meta"].temp_bytes / 1e9
    tr = training_roofline(env, dev)
    rows["train"] = roofline_row(tr["cfg"], tr["shape"], tr["cost"],
                                 torch.float32,
                                 {"step": training["step_ms"]})
    rows["train"]["meta_temp_gb"] = tr["meta"].temp_bytes / 1e9
    for kind, row in rows.items():
        for what, sh in row["shares"].items():
            if not (0 < sh["fraction"] <= 1 and 0 < sh["mfu"] <= 1):
                fail(f"phase 20: {kind} share against {what} outside "
                     f"(0, 1]: {sh} (a share above 1 means the count is "
                     f"wrong)")
    log("phase 20: (b, c) counted on the card == counted on meta (FLOPs "
        "and bytes) for qwen3-4b's 8 x 1024 prefill and one decode step "
        "(phase 12's model, full width and depth, f32) and phase 18's "
        f"training step ({tr['cfg'].name}, 8 x 128, f32); against "
        "NVIDIA H100 SXM5 peaks: " + "; ".join(
            f"{kind}: {r['flops']:.4g} FLOPs, {r['bytes']:.4g} bytes, bound "
            f"{r['bound_ms']:.4g} ms ({r['dominant']}; compute "
            f"{r['t_compute_ms']:.4g}, memory {r['t_memory_ms']:.4g}), "
            f"model FLOPs {r['model_flops']:.4g}, temp {r['temp_gb']:.2f} "
            f"GB on the card ({r['meta_temp_gb']:.2f} GB counted on meta); "
            + ", ".join(f"{what} {sh['ms']:.4g} ms: roofline fraction "
                        f"{sh['fraction']:.4f}, MFU {sh['mfu']:.4f}"
                        for what, sh in r["shares"].items())
            for kind, r in rows.items()))
    return {"dryrun": cells, "rows": rows}


# ----------------------------------------------------------------- CLIs

SERVE_MODES = {
    "static": [],
    "split2": ["--split", "2"],
    "auto": ["--split", "auto"],
    "arrival": ["--split", "auto", "--workload", "tenantA,tenantB",
                "--arrival", "onoff:64,0.5,0.5"],
    "slo": ["--split", "auto", "--workload", "tenantA,tenantB",
            "--slo-ms", "2.5"],
    "tenant_slo": ["--split", "auto", "--tenant-slo",
                   "tenantA:2.5:1:1,tenantB:4:1:0", "--admission"]}
WALL_FIELDS = r" in \d+\.\d+s \(\d+\.\d+ tok/s\)"


def cli_lines(main, argv) -> list:
    """A launcher's printed lines, less each round's wall-clock fields."""
    import contextlib
    import io
    import re
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return [re.sub(WALL_FIELDS, "", ln) for ln in buf.getvalue().splitlines()]


def phase_clis(env: Env, dev) -> dict:
    """Phase 19: ``launch.serve.main`` in six modes on the card, each line
    (tokens, pages, governor decisions, SLO and admission lines, pool
    stats) equal to the same run on the CPU in this process, the card's
    runs through the kernels; ``launch.train.main`` of h2o-danube-1.8b for
    12 steps on the card."""
    att = env.att
    t0 = time.perf_counter()
    out = {}
    for mode, flags in SERVE_MODES.items():
        argv = ["--arch", "qwen3-4b"] + flags
        cpu = cli_lines(env.launch_serve.main, argv + ["--device", "cpu"])
        att.reset_launches()
        t1 = time.perf_counter()
        card = cli_lines(env.launch_serve.main, argv)
        wall = time.perf_counter() - t1
        if card != cpu:
            fail(f"serve CLI {mode}: the card's lines differ from the CPU's:"
                 f"\n{card}\n{cpu}")
        if any(att.plain_runs.values()) or not (
                att.launches["flash_attention"]
                and att.launches["decode_attention"]):
            fail(f"serve CLI {mode}: launches {att.launches}, plain runs "
                 f"{att.plain_runs}")
        out[mode] = {"lines": len(card), "wall_s": wall,
                     "launches": dict(att.launches)}
    import shutil
    ckpt = ROOT / "build" / "chip_smoke_train_cli"
    shutil.rmtree(ckpt, ignore_errors=True)
    att.reset_launches()
    lines = cli_lines(env.launch_train.main,
                      ["--arch", "h2o-danube-1.8b", "--steps", "12",
                       "--ckpt-dir", str(ckpt)])
    shutil.rmtree(ckpt, ignore_errors=True)
    import re
    m = re.match(r"done: steps=12 restarts=0 stragglers=\d+ loss "
                 r"(\d+\.\d+) -> (\d+\.\d+)", lines[-1])
    if not m or any(att.plain_runs.values()) or \
            not att.launches["flash_attention_backward"]:
        fail(f"train CLI: {lines[-1]!r}, launches {att.launches}, plain "
             f"runs {att.plain_runs}")
    out["train"] = {"line": lines[-1], "launches": dict(att.launches)}
    log("phase 19: serve CLI on the card == on the CPU in " + ", ".join(
        f"{k} ({v['lines']} lines, {v['wall_s']:.1f} s)"
        for k, v in out.items() if k != "train")
        + f"; train CLI h2o-danube-1.8b on the card: {lines[-1]}, launches "
        f"{json.dumps(out['train']['launches'])}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------- more than one device

MESH_RANKS = 4               # (b): gloo ranks, processes sharing the card
MESH_TIMEOUT_S = 480         # (b): the world's join
MESH_MOE_ARCH = "deepseek-moe-16b"
MESH_MOE_TOKENS = 1024       # the layer's input rows: 8 prompts x 128
MESH_MOE_SEED = 24
MESH_MOE_SHAPES = ((1, 4), (2, 2))
MESH_TRAIN_ARCH = "qwen3-4b"
MESH_CKPT = ROOT / "build" / "chip_smoke_mesh"
# train.loop.train of the golden cell's config: MESH_LOOP_STEPS steps with
# the supervisor's checkpoint at the last, then resumed to MESH_LOOP_RESUME;
# in one process, on (1, 1) over NCCL and on (2, 1) over gloo
MESH_LOOP_STEPS, MESH_LOOP_RESUME = 2, 3
MESH_LOOP_BATCH = 4          # x TRAIN_SEQ: two rows a rank on (2, 1)
MESH_LOOP_SEED = 5


def compute_mode() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def moe_layer_inputs(env: Env, dev) -> tuple:
    """(cfg, weights, x, gy) of deepseek-moe-16b's MoE layer at full width
    (64 routed experts of 2048 x 1408 and 2 shared, f32, the reference's
    distributions), its input rows and the cotangent of its output, drawn
    on the card from one seed (so every rank draws the same)."""
    cfg = env.configs.get(MESH_MOE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(MESH_MOE_SEED)

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                torch.randn(v.shape, generator=gen, device=dev) * v.scale
                for k, v in tree.items()}
    p = draw(env.models.moe.init_moe(cfg))
    x = torch.randn((MESH_MOE_TOKENS, cfg.d_model), generator=gen,
                    device=dev)
    gy = torch.randn(x.shape, generator=gen, device=dev)
    return cfg, p, x, gy


def moe_leaves(p) -> list:
    return [p["router"], p["w_gate"], p["w_up"], p["w_down"]] + \
        [p["shared"][k] for k in sorted(p["shared"])]


def moe_on_mesh(env: Env, mesh, dev) -> dict:
    """The MoE layer expert-parallel on ``mesh`` (this rank's tokens, its
    experts' shards only) against the one-process layer on the same tokens
    with every expert: each row of the output within 1e-4 of that row's
    max |y|, each gradient (the rank's expert slices, the router summed
    over ``model``, the shared experts, the input) within 1e-3 of the
    leaf's max |gradient|."""
    sh = env.sharding
    cfg, p, x, gy = moe_layer_inputs(env, dev)
    spec = sh.batch_spec(mesh, x.shape[0])
    x, gy = sh.local_shard(x, spec, mesh), sh.local_shard(gy, spec, mesh)
    full = moe_leaves(p)
    for t in full:
        t.requires_grad_(True)
    x1 = x.clone().requires_grad_(True)
    y1 = env.models.moe.moe_mlp(p, x1, cfg)
    g1 = torch.autograd.grad((y1 * gy).sum(), full + [x1])
    e_local = cfg.num_experts // sh.axis_sizes(mesh)["model"]
    e_lo = sh.coordinate(mesh)["model"] * e_local
    local = {"router": p["router"].detach().clone(),
             "shared": {k: v.detach().clone()
                        for k, v in p["shared"].items()}}
    for k in ("w_gate", "w_up", "w_down"):
        local[k] = sh.local_shard(p[k].detach(), ("model", None, None),
                                  mesh).clone()
    want = [g1[0]] + [g[e_lo:e_lo + e_local] for g in g1[1:4]] + \
        list(g1[4:])
    y1 = y1.detach()
    del p, full, g1
    torch.cuda.empty_cache()
    mine = moe_leaves(local)
    for t in mine:
        t.requires_grad_(True)
    x2 = x.clone().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with env.context.use_mesh(mesh):
        y = env.models.moe.moe_mlp(local, x2, cfg)
        g = list(torch.autograd.grad((y * gy).sum(), mine + [x2]))
    torch.distributed.all_reduce(g[0], group=mesh.get_group("model"))
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    row_err = float(((y.detach() - y1).abs().amax(1)
                     / y1.abs().amax(1).clamp_min(1e-30)).max())
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(
        1e-30)) for a, b in zip(g, want))
    shape = tuple(mesh.shape)
    if not (row_err <= 1e-4 and grad_err <= 1e-3):
        fail(f"MoE on {shape}: output rows {row_err:.3g} of their max "
             f"(bound 1e-4), gradients {grad_err:.3g} of their max (bound "
             f"1e-3)")
    return {"tokens": x.shape[0], "experts": e_local, "row_err": row_err,
            "grad_err": grad_err, "s": s,
            "expert_gb": sum(local[k].numel() * 4 for k in
                             ("w_gate", "w_up", "w_down")) / 1e9}


def mesh_train_config(env: Env, common: dict):
    """The golden training cell's config: the arch, depth cut."""
    return dataclasses.replace(env.configs.get(MESH_TRAIN_ARCH),
                               name=f"{MESH_TRAIN_ARCH}-"
                                    f"{common['num_layers']}l",
                               num_layers=common["num_layers"])


def mesh_train_cell(env: Env, mesh, dev) -> dict:
    """The qwen3-4b golden training cell (``tests/data/torch_golden_train
    .json``: full width, 2 decoder layers) through the step ``train``
    builds with a mesh (``make_train_step(mesh=...)``, this rank's rows by
    ``shard_batch``, the mesh installed), fed the golden batch (``train``'s
    pipeline draws other batches from numpy 2.3, ROADMAP §C 5, and its
    cosine schedule is not the cell's constant rate): step-0 loss within
    1e-4, the losses after steps 1 and 2 within 1e-3, ``grad_norm`` within
    1e-3.  Returns the trained model and state too."""
    golden = json.loads(GOLDEN_TRAIN.read_text())
    common, want = golden["common"], golden["cells"][MESH_TRAIN_ARCH]
    cfg = mesh_train_config(env, common)
    model = env.models.LM(cfg, device=dev)
    opt = env.optim.AdamW(learning_rate=common["learning_rate"])
    state = env.train_step.init_state(
        model, opt, env.models.seeded_numpy_params(cfg, common["seed"]))
    step = env.train_step.make_train_step(model, opt, mesh=mesh)
    batch = env.data.shard_batch(
        {k: np.asarray(v, np.int64) for k, v in want["batch"].items()},
        mesh, device=dev)
    env.obs.enable(trace=True, metrics=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, norms = [], []
    with env.context.use_mesh(mesh):
        for _ in range(common["steps"]):
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
    s = time.perf_counter() - t0
    reduce = collective_use(env, "train.all_reduce", "train_all_reduce_bytes")
    env.obs.disable()
    err = {"loss": abs(losses[0] - want["loss"][0]) / abs(want["loss"][0]),
           "steps": max(abs(a - b) / abs(b) for a, b in
                        zip(losses[1:], want["loss"][1:])),
           "grad_norm": abs(norms[0] - want["grad_norm"])
           / want["grad_norm"]}
    if err["loss"] > 1e-4 or err["steps"] > 1e-3 or err["grad_norm"] > 1e-3:
        fail(f"golden training on {tuple(mesh.shape)}: losses {losses} "
             f"(reference {want['loss']}), grad_norm {norms[0]} "
             f"(reference {want['grad_norm']})")
    return {"cfg": cfg, "state": state, "rows": int(batch["tokens"].shape[0]),
            "losses": losses, "err": err, "s": s, "all_reduce": reduce}


def mesh_loop(env: Env, cfg, mesh, dev, ckpt: Path) -> dict:
    """``train.loop.train`` of ``cfg`` on ``mesh`` (None: one process, no
    mesh) with the supervisor's checkpoints in ``ckpt``:
    ``MESH_LOOP_STEPS`` steps, the mesh's first rank writing the state at
    the last step and every rank waiting for it, then a second call that
    resumes from it to ``MESH_LOOP_RESUME``.  The losses, the reports
    and the seconds."""
    kw = dict(batch=MESH_LOOP_BATCH, seq=TRAIN_SEQ, seed=MESH_LOOP_SEED,
              device=dev, mesh=mesh, ckpt_dir=str(ckpt),
              ckpt_every=MESH_LOOP_STEPS, print_fn=lambda *_: None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, first, rep = env.train_loop.train(cfg, steps=MESH_LOOP_STEPS,
                                             **kw)
    del state
    state, then, rep2 = env.train_loop.train(cfg, steps=MESH_LOOP_RESUME,
                                             **kw)
    del state
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    ctx = f"train on {tuple(mesh.shape) if mesh is not None else 'no mesh'}"
    if not (rep.steps_run == MESH_LOOP_STEPS and rep.restarts == 0
            and rep2.resumed_from == MESH_LOOP_STEPS and rep2.restarts == 0
            and rep2.steps_run == MESH_LOOP_RESUME - MESH_LOOP_STEPS):
        fail(f"{ctx}: supervisor reports {rep} then {rep2}")
    losses = first + then
    if not all(math.isfinite(x) for x in losses):
        fail(f"{ctx}: a loss is not finite {losses}")
    return {"losses": losses, "s": s}


def hold_loop(got: list, one: list, ctx: str) -> dict:
    """A ``mesh_loop``'s losses against the one-process run's: the first
    within 1e-4 relative, the later ones within 1e-3 (the golden training
    bounds; the mean of equal shards' mean losses and gradients is the
    whole batch's, up to f32 rounding)."""
    err = {"loss": abs(got[0] - one[0]) / abs(one[0]),
           "steps": max(abs(a - b) / abs(b) for a, b in zip(got[1:],
                                                            one[1:]))}
    if len(got) != len(one) or err["loss"] > 1e-4 or err["steps"] > 1e-3:
        fail(f"{ctx}: losses {got}, one process {one}")
    return err


def block_of(arr, spec, coord: dict, sizes: dict):
    """``arr``'s block at ``coord`` under ``spec`` (the first axis of a
    dim's tuple major), cut by index arithmetic of its own."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx, cnt = 0, 1
        for a in ((entry,) if isinstance(entry, str) else entry):
            idx, cnt = idx * sizes[a] + coord[a], cnt * sizes[a]
        n = arr.shape[d] // cnt
        arr = arr.narrow(d, idx * n, n)
    return arr


def elastic_check(env: Env, cfg, mesh, dev) -> dict:
    """``restore_on_mesh`` on ``mesh`` of the parameters of the latest
    training state in ``MESH_CKPT`` (the supervisor's, written by rank 0):
    each shard bit-identical to its block of the checkpoint's full
    leaf."""
    ckpt = env.checkpoint.latest(MESH_CKPT)
    template = env.train_step.TrainState(env.models.weights.param_tree(
        env.models.LM(cfg, device=dev)), None, None)
    step, shards = env.checkpoint.restore_on_mesh(ckpt, template, mesh)
    _, full = env.checkpoint.restore(ckpt, template)
    sh, pt = env.sharding, env.pytree
    coord, sizes = sh.coordinate(mesh), sh.axis_sizes(mesh)
    held = cut = n = 0
    for (name, got), (_, leaf) in zip(pt.flatten(shards), pt.flatten(full)):
        key = name.rsplit("/", 1)[-1]       # the rules read the leaf's key
        spec = sh.param_specs({key: leaf}, mesh)[key]
        n += 1
        want = block_of(torch.from_numpy(leaf.numpy()), spec, coord, sizes)
        if not torch.equal(torch.from_numpy(got.numpy()), want):
            fail(f"restore_on_mesh {name}: the shard at {coord} differs "
                 f"from its block of the full leaf")
        held += want.numel()
        cut += any(e is not None for e in spec)
    return {"step": step, "leaves": n, "sharded_leaves": cut,
            "held": held,
            "full": sum(leaf.numpy().size for _, leaf in pt.flatten(full))}


def collective_use(env: Env, span: str, counter: str) -> dict:
    """(calls, seconds, bytes) of a collective span and its byte counter
    in the obs run just ended."""
    s = env.obs.tracer().summary().get(span, {})
    m = env.obs.metrics_registry().get(counter)
    return {"calls": s.get("count", 0), "s": s.get("total_us", 0.0) / 1e6,
            "bytes": int(m.total()) if m is not None else 0}


def mesh_fleet(env: Env, g: dict, mesh, dev) -> dict:
    """The 64-replica golden fleet over ``mesh``'s fleet axis, the scans'
    counts set to 0 before and read after; the gathers' calls, seconds
    and bytes (obs span ``fleet.gather``)."""
    env.scan.reset_launches()
    env.obs.enable(trace=True, metrics=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fr = env.fleet.simulate_fleet(fleet_specs(env, g, g["replicas"]),
                                  device=dev, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gather = collective_use(env, "fleet.gather", "fleet_gather_bytes")
    env.obs.disable()
    return {"wall_s": wall, "gather": gather, "names": fr.names,
            "epochs": fr.epochs, "dispatches": fr.dispatches,
            "mesh_devices": fr.mesh_devices,
            "launches": dict(env.scan.launches),
            "plain": dict(env.scan.plain_runs),
            "records": [replica_record(env, r) for r in fr.results]}


def hold_fleet(got: dict, g: dict, card: dict, first: bool,
               ctx: str) -> tuple:
    """A fleet run on a mesh against the golden file (decisions, splits,
    integer Stats identical, floats within 1e-3) and phase 15's run on
    one card (``ipc`` and rewards within 1e-9).  The first rank of the
    axis holds a group's first rows, so it launches as the one card did;
    a rank whose rows are all padding skips the scans (``_run_packed``
    launches nothing on a zero-length pack)."""
    want = card["launches"]
    ok = got["launches"] == want if first else all(
        0 < got["launches"][k] <= want[k] for k in want)
    if got["names"] != g["names"] or got["epochs"] != g["epochs"] or \
            got["dispatches"] != g["dispatches"] or \
            any(got["plain"].values()) or not ok:
        fail(f"{ctx}: {got['epochs']} steps, {got['dispatches']} "
             f"dispatches (golden {g['epochs']}, {g['dispatches']}), "
             f"launches {got['launches']} (one card {want}), plain runs "
             f"{got['plain']}")
    err = max(hold_replica(a, w, f"{ctx} replica {i}") for i, (a, w) in
              enumerate(zip(got["records"], g["replicas_results"])))
    one = max(same_replica(a, b, f"{ctx} vs one card, replica {i}")
              for i, (a, b) in enumerate(zip(got["records"],
                                             card["records"])))
    return err, one


def mesh_rank(rank: int, golden_fleet: dict) -> dict:
    """One rank of (b)'s gloo world: a process of its own on the card,
    importing neither JAX nor the reference."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    env = Env()
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    out = {"rank": rank,
           "fleet": mesh_fleet(env, golden_fleet,
                               env.mesh.make_fleet_mesh(), dev)}
    out["moe"] = {shape: moe_on_mesh(env, init_device_mesh(
        dev.type, shape, mesh_dim_names=("data", "model")), dev)
        for shape in MESH_MOE_SHAPES}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    train_mesh = DeviceMesh(dev.type, torch.arange(2).reshape(2, 1),
                            mesh_dim_names=("data", "model"))
    env.att.reset_launches()
    if train_mesh.get_coordinate() is not None:
        cell = mesh_train_cell(env, train_mesh, dev)
        cfg = cell.pop("cfg")
        del cell["state"]
        torch.cuda.empty_cache()
        cell["loop"] = mesh_loop(env, cfg, train_mesh, dev, MESH_CKPT)
        cell["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["train"] = cell
    else:
        cfg = mesh_train_config(
            env, json.loads(GOLDEN_TRAIN.read_text())["common"])
    out["att"] = {"launches": dict(env.att.launches),
                  "plain": dict(env.att.plain_runs)}
    torch.cuda.empty_cache()
    env.world.barrier()
    out["elastic"] = elastic_check(env, cfg, env.mesh.make_dev_mesh(2), dev)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["s"] = time.perf_counter() - t0
    out["jax"] = [m for m in ("jax", "repro") if m in sys.modules]
    return out


def phase_multi_device(env: Env, dev, fleet: dict) -> dict:
    """Phase 21: more than one device.  (a) a world of one rank over NCCL
    on the card, in this process: the 64-replica golden fleet under
    ``make_fleet_mesh()``, the full-width MoE layer on a (1, 1) mesh, the
    qwen3-4b golden training cell on (1, 1), and ``train.loop.train`` of
    its config on (1, 1) with a checkpoint and a resumption, held to the
    same call in one process without a mesh; (b) a gloo world of
    ``MESH_RANKS`` processes sharing the card (``distributed.world.spawn``):
    the fleet on a fleet axis of 4, each rank advancing 16 rows of a
    B = 64 group, the MoE layer on (1, 4) and (2, 2), the golden training
    cell on (2, 1) (one row a rank), ``train.loop.train`` on (2, 1) as in
    (a), ``restore_on_mesh`` on (2, 2) of the checkpoint its supervisor
    wrote from rank 0."""
    import shutil
    import tempfile
    g = json.loads(GOLDEN_FLEET.read_text())["fleet"]
    card = fleet["fleet"]
    mode = compute_mode()
    t0 = time.perf_counter()
    loop_cfg = mesh_train_config(
        env, json.loads(GOLDEN_TRAIN.read_text())["common"])
    loop_ckpt = ROOT / "build" / "chip_smoke_loop"
    shutil.rmtree(loop_ckpt, ignore_errors=True)
    one_loop = mesh_loop(env, loop_cfg, None, dev, loop_ckpt)
    shutil.rmtree(loop_ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    rdv = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    env.world.init_world("nccl", 0, 1, f"file://{rdv}/rendezvous")
    nccl_fleet = mesh_fleet(env, g, env.mesh.make_fleet_mesh(), dev)
    f_err, f_one = hold_fleet(nccl_fleet, g, card, True,
                              "fleet, NCCL world of 1")
    mesh11 = env.mesh.make_dev_mesh(1)
    nccl_moe = moe_on_mesh(env, mesh11, dev)
    torch.cuda.empty_cache()
    env.att.reset_launches()
    nccl_train = mesh_train_cell(env, mesh11, dev)
    nccl_train.pop("cfg"), nccl_train.pop("state")
    torch.cuda.empty_cache()
    nccl_loop = mesh_loop(env, loop_cfg, mesh11, dev, loop_ckpt)
    nccl_loop["err"] = hold_loop(nccl_loop["losses"], one_loop["losses"],
                                 "train on (1, 1), NCCL")
    shutil.rmtree(loop_ckpt, ignore_errors=True)
    nccl_att = dict(env.att.launches)
    if any(env.att.plain_runs.values()):
        fail(f"phase 21 (a): plain attention runs {env.att.plain_runs}")
    torch.distributed.destroy_process_group()
    shutil.rmtree(rdv, ignore_errors=True)
    torch.cuda.empty_cache()
    a_s = time.perf_counter() - t0
    log(f"phase 21 (a): NCCL world of 1 rank on the card: fleet of "
        f"{g['replicas']} on a fleet axis of 1 in {nccl_fleet['wall_s']:.3f}"
        f" s (phase 15 {fleet['fleet']['wall_s']:.3f} s), launches "
        f"{json.dumps(nccl_fleet['launches'])}, == the golden (float rel err "
        f"{f_err:.3g}) and phase 15's run (rel err {f_one:.3g}, bound "
        f"1e-9); {MESH_MOE_ARCH} MoE layer at full width on (1, 1): "
        f"{nccl_moe['tokens']} rows, output rows {nccl_moe['row_err']:.3g} "
        f"of their max, gradients {nccl_moe['grad_err']:.3g}; golden "
        f"training cell {MESH_TRAIN_ARCH} on (1, 1): losses "
        f"{nccl_train['losses']}, rel err loss {nccl_train['err']['loss']:.3g}"
        f", steps {nccl_train['err']['steps']:.3g}, grad_norm "
        f"{nccl_train['err']['grad_norm']:.3g}; train.loop.train of its "
        f"config, batch {MESH_LOOP_BATCH} x {TRAIN_SEQ}, {MESH_LOOP_STEPS} "
        f"steps, checkpointed and resumed to {MESH_LOOP_RESUME}: one process "
        f"losses {one_loop['losses']} in {one_loop['s']:.1f} s, (1, 1) "
        f"{nccl_loop['losses']} in {nccl_loop['s']:.1f} s (rel err loss "
        f"{nccl_loop['err']['loss']:.3g}, steps "
        f"{nccl_loop['err']['steps']:.3g}); attention launches "
        f"{json.dumps(nccl_att)}; {a_s:.1f} s")

    t1 = time.perf_counter()
    shutil.rmtree(MESH_CKPT, ignore_errors=True)
    ranks = env.world.spawn(mesh_rank, MESH_RANKS, g, backend="gloo",
                            timeout_s=MESH_TIMEOUT_S)
    b_s = time.perf_counter() - t1
    shutil.rmtree(MESH_CKPT, ignore_errors=True)
    for r in ranks:
        if r["jax"]:
            fail(f"phase 21 (b): rank {r['rank']} imported {r['jax']}")
        if r["fleet"]["mesh_devices"] != MESH_RANKS:
            fail(f"phase 21 (b): rank {r['rank']}'s fleet axis is "
                 f"{r['fleet']['mesh_devices']}")
        r["fleet_err"] = hold_fleet(r["fleet"], g, card, r["rank"] == 0,
                                    f"fleet, gloo rank {r['rank']}")
        if any(r["att"]["plain"].values()):
            fail(f"phase 21 (b): rank {r['rank']} ran plain attention "
                 f"{r['att']['plain']}")
    trained = [r for r in ranks if "train" in r]
    if [r["rank"] for r in trained] != [0, 1] or \
            trained[0]["train"]["losses"] != trained[1]["train"]["losses"] \
            or trained[0]["train"]["loop"]["losses"] != \
            trained[1]["train"]["loop"]["losses"]:
        fail("phase 21 (b): the (2, 1) training ranks disagree")
    for r in trained:
        r["train"]["loop"]["err"] = hold_loop(
            r["train"]["loop"]["losses"], one_loop["losses"],
            f"train on (2, 1), gloo rank {r['rank']}")
    el = [r["elastic"] for r in ranks]
    if sum(e["held"] for e in el) < el[0]["full"]:
        fail(f"phase 21 (b): the (2, 2) shards hold "
             f"{sum(e['held'] for e in el)} of {el[0]['full']} elements")
    log(f"phase 21 (b): gloo world of {MESH_RANKS} processes sharing the "
        f"card (compute mode {mode}), {b_s:.1f} s with the world's start: "
        + "; ".join(
            f"rank {r['rank']}: fleet {r['fleet']['wall_s']:.3f} s (phase "
            f"15 {fleet['fleet']['wall_s']:.3f} s; "
            f"{r['fleet']['gather']['calls']} gathers, "
            f"{r['fleet']['gather']['s']:.3f} s, "
            f"{r['fleet']['gather']['bytes'] / 1e6:.1f} MB), launches "
            f"{json.dumps(r['fleet']['launches'])}, == the golden (float rel "
            f"err {r['fleet_err'][0]:.3g}) and phase 15 ({r['fleet_err'][1]:.3g});"
            " MoE " + ", ".join(
                f"{s}: {m['tokens']} rows, {m['experts']} experts "
                f"({m['expert_gb']:.2f} GB), rows {m['row_err']:.3g}, "
                f"gradients {m['grad_err']:.3g}, {m['s']:.3f} s"
                for s, m in r["moe"].items())
            + (f"; training (2, 1): {r['train']['rows']} row, losses "
               f"{r['train']['losses']}, rel err loss "
               f"{r['train']['err']['loss']:.3g}, steps "
               f"{r['train']['err']['steps']:.3g}, grad_norm "
               f"{r['train']['err']['grad_norm']:.3g}, {r['train']['s']:.2f}"
               f" s ({r['train']['all_reduce']['calls']} gradient "
               f"all-reduces, {r['train']['all_reduce']['s']:.2f} s, "
               f"{r['train']['all_reduce']['bytes'] / 1e9:.2f} GB); "
               f"train.loop.train (2, 1): losses "
               f"{r['train']['loop']['losses']} (rel err loss "
               f"{r['train']['loop']['err']['loss']:.3g}, steps "
               f"{r['train']['loop']['err']['steps']:.3g}), "
               f"{r['train']['loop']['s']:.1f} s; peak "
               f"{r['train']['peak_gb']:.2f} GB"
               if "train" in r else "")
            + f"; attention launches {json.dumps(r['att']['launches'])}; "
            f"restore_on_mesh (2, 2): {r['elastic']['sharded_leaves']} of "
            f"{r['elastic']['leaves']} leaves cut, {r['elastic']['held']} "
            f"elements held, bit-identical; peak {r['peak_gb']:.2f} GB, "
            f"{r['s']:.1f} s" for r in ranks))
    scans = {k: nccl_fleet["launches"][k] + sum(
        r["fleet"]["launches"][k] for r in ranks)
        for k in ("conv_scan", "ext_scan")}
    att = {k: nccl_att[k] + sum(r["att"]["launches"][k] for r in ranks)
           for k in nccl_att}
    log(f"phase 21: launches {json.dumps(scans)} (stateful scans), "
        f"{json.dumps(att)} (attention), no plain run; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"scans": scans, "attention": att,
            "nccl": {"fleet": nccl_fleet["launches"], "attention": nccl_att},
            "gloo_ranks": [{"fleet": r["fleet"]["launches"],
                            "attention": r["att"]["launches"]}
                           for r in ranks]}


# ------------------------------------------------------------- phase 22

TP_ARCH = "qwen3-4b"             # (b): phase 18's config, 8 layers
TP_MESH = (1, 2)
TP_PROMPT = (4, 128)             # (b): prompts x tokens
TP_NEW = 8                       # (b): greedy decode steps
TP_TRAIN = (4, 128)              # (b): the train step's batch
TP_SEED = 22
TP_LOGIT_TOL = 1e-4              # logits, tensor-parallel vs one process
TP_LOSS_TOL = 1e-5               # the train step's loss, relative
TP_GRAD_TOL = 1e-4               # each gradient leaf's norm, relative
CP_ARCH = "qwen2-vl-7b"          # (c): the context-parallel path
CP_LAYERS = 2
CP_MESH = (1, 3)
CP_SEQ = 3072                    # a multiple of 3: the rows split evenly
CP_NEW = 6                       # (c): decode steps over the sharded cache
CP_TIMEOUT_S = 600
# (a): qwen2-vl-7b's context-parallel block on (1, 3) and qwen3-4b's
# decode cache, split in two
QSTART_CASE = dict(b=1, s=CP_SEQ, h=28, kv=4, hd=128)
LSE_CASE = dict(b=8, h=32, kv=8, hd=128, t=4096)


def tp_config(env: Env, arch: str, layers: int):
    return dataclasses.replace(env.configs.get(arch),
                               name=f"{arch}-{layers}l", num_layers=layers)


def q_start_blocks(s: int, n: int) -> list:
    return [(r * s // n, (r + 1) * s // n) for r in range(n)]


def phase22_kernels(env: Env, dev) -> dict:
    """Phase 22 (a): the two kernel options against their plain versions:
    the flash forward and backward with ``q_start`` on the three row
    blocks of qwen2-vl-7b's context-parallel prefill (f32 and bf16), and
    ``decode_attention_with_lse`` on the two halves of qwen3-4b's decode
    cache, merged, against the whole call.  Times, bounds, the library's
    time, and the calls without the option at the same shapes (the
    instances launched before the options existed)."""
    c = QSTART_CASE
    rng = np.random.default_rng(TP_SEED)
    out = {"flash": {}, "backward": {}, "decode": {}}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        q = att_randn(rng, (c["b"], c["s"], c["h"], c["hd"]), dtype, dev)
        k = att_randn(rng, (c["b"], c["s"], c["kv"], c["hd"]), dtype, dev)
        v = att_randn(rng, (c["b"], c["s"], c["kv"], c["hd"]), dtype, dev)
        do = att_randn(rng, tuple(q.shape), dtype, dev)
        errs, berrs, rows = [], [], {}
        for a, e in q_start_blocks(c["s"], CP_MESH[1]):
            qb, dob = q[:, a:e].contiguous(), do[:, a:e].contiguous()
            kw = dict(causal=True, window=0, softcap=0.0, q_start=a)
            fwd = lambda: env.att.flash_attention_with_lse(qb, k, v, **kw)
            o, lse = fwd()
            errs.append(att_close(
                o, env.att.flash_attention_plain(qb, k, v, **kw),
                att_tol("flash_attention", dtype),
                f"phase 22 (a): flash q_start {a} {dn}"))
            want = env.att.flash_lse_plain(qb, k, **kw)
            if float((lse - want).abs().max()) > LSE_TOL[dtype]:
                fail(f"phase 22 (a): flash q_start {a} {dn}: log-sum-exp "
                     f"off by {float((lse - want).abs().max())}")
            bwd = lambda: env.att.flash_attention_backward(
                qb, k, v, o, dob, lse, **kw)
            got = bwd()
            want = env.att.flash_attention_backward_plain(qb, k, v, o, dob,
                                                          **kw)
            atol, rtol = BWD_TOL[dtype]
            for g, w, nm in zip(got, want, ("dq", "dk", "dv")):
                berrs.append(att_close(g, w, (atol, rtol),
                                       f"phase 22 (a): {nm} q_start {a} "
                                       f"{dn}"))
            args = (qb, k, v)
            t = times(lambda: env.att.flash_attention(qb, k, v, **kw),
                      lambda: env.att.flash_attention_plain(qb, k, v, **kw),
                      5, 2, sdpa_call("flash_attention", args, kw))
            tb = times(bwd, lambda: env.att.flash_attention_backward_plain(
                qb, k, v, o, dob, **kw), 5, 2)
            library = sdpa_backward(qb, k, v, dob, kw)   # autograd: no graph
            tb["library_ms"] = timed_cuda(library, 5) if library else None
            del library
            rows[a] = {"forward": t | {"bound": attention_bound(
                "flash_attention", args, kw)},
                "backward": tb | {"bound": bwd_bound(qb, k, v, kw)}}
        # the call without an offset at the whole shape: the instance
        # every earlier phase launches
        kw0 = dict(causal=True, window=0, softcap=0.0)
        whole = device_ms(lambda: env.att.flash_attention(q, k, v, **kw0), 5)
        o0, lse0 = env.att.flash_attention_with_lse(q, k, v, **kw0)
        whole_b = device_ms(lambda: env.att.flash_attention_backward(
            q, k, v, o0, do, lse0, **kw0), 5)
        out["flash"][dn] = {"err": max(errs), "blocks": {
            a: r["forward"] for a, r in rows.items()}, "whole_ms": whole}
        out["backward"][dn] = {"err": max(berrs), "blocks": {
            a: r["backward"] for a, r in rows.items()},
            "whole_ms": whole_b}
    d = LSE_CASE
    q = att_randn(rng, (d["b"], d["h"], d["hd"]), torch.float32, dev)
    k = att_randn(rng, (d["b"], d["t"], d["kv"], d["hd"]), torch.float32, dev)
    v = att_randn(rng, (d["b"], d["t"], d["kv"], d["hd"]), torch.float32, dev)
    valid = torch.ones((d["b"], d["t"]), dtype=torch.bool, device=dev)
    half = d["t"] // 2
    outs, lses, errs = [], [], []
    for a, e in ((0, half), (half, d["t"])):
        kb, vb = k[:, a:e].contiguous(), v[:, a:e].contiguous()
        vd = valid[:, a:e].contiguous()
        o, lse = env.att.decode_attention_with_lse(q, kb, vb, vd)
        wo, wl = env.att.decode_attention_plain(q, kb, vb, vd, with_lse=True)
        errs.append(att_close(o, wo, att_tol("decode_attention",
                                             torch.float32),
                              f"phase 22 (a): decode half {a}"))
        if float((lse - wl).abs().max()) > LSE_TOL[torch.float32]:
            fail(f"phase 22 (a): decode half {a}: log-sum-exp off by "
                 f"{float((lse - wl).abs().max())}")
        outs.append(o)
        lses.append(lse)
    merged = env.att.combine_decode(torch.stack(outs), torch.stack(lses))
    errs.append(att_close(merged, env.att.decode_attention_plain(
        q, k, v, valid), att_tol("decode_attention", torch.float32),
        "phase 22 (a): the halves merged against the whole call"))
    kb, vb, vd = k[:, :half].contiguous(), v[:, :half].contiguous(), \
        valid[:, :half].contiguous()
    args = (q, kb, vb, vd)
    t = times(lambda: env.att.decode_attention_with_lse(*args),
              lambda: env.att.decode_attention_plain(*args, with_lse=True),
              20, 5, sdpa_call("decode_attention", args, {}))
    work = kernel_work()
    t["bound"] = work.bound_ms(work.attention_work(
        "decode_attention", args, {}, with_lse=True))
    t["without_lse_ms"] = device_ms(
        lambda: env.att.decode_attention(*args), 20)
    out["decode"] = t | {"err": max(errs), "shape": {**d, "t": half}}
    log("phase 22 (a): " + "; ".join(
        f"flash {dn} q_start blocks of {c['s']} rows x {c['s']} keys, H "
        f"{c['h']}/{c['kv']}, hd {c['hd']}: max abs err forward "
        f"{out['flash'][dn]['err']:.3g}, backward "
        f"{out['backward'][dn]['err']:.3g}; " + ", ".join(
            f"rows from {a}: forward {r['ms']:.4g} ms (plain "
            f"{r['plain_ms']:.4g}, SDPA {ms_text(r['library_ms'])}, bound "
            f"{r['bound'][0]:.4g} {r['bound'][1]}), backward "
            f"{out['backward'][dn]['blocks'][a]['ms']:.4g} ms (plain "
            f"{out['backward'][dn]['blocks'][a]['plain_ms']:.4g}, bound "
            f"{out['backward'][dn]['blocks'][a]['bound'][0]:.4g})"
            for a, r in out["flash"][dn]["blocks"].items())
        + "; the whole call without q_start "
        f"{out['flash'][dn]['whole_ms']:.4g} ms forward, {out['backward'][dn]['whole_ms']:.4g} ms backward"
        for dn in out["flash"])
        + f"; decode_attention_with_lse f32 B{d['b']} H{d['h']}/{d['kv']} "
        f"T {half} (a half of {d['t']}), halves merged == the whole call "
        f"(max abs err {out['decode']['err']:.3g}): {t['ms']:.4g} ms (without"
        f" the log-sum-exp {t['without_lse_ms']:.4g} ms, plain "
        f"{t['plain_ms']:.4g}, SDPA {ms_text(t['library_ms'])}, bound "
        f"{t['bound'][0]:.4g} {t['bound'][1]})")
    return out


def loss_and_grad_norms(env: Env, model, batch: dict) -> tuple:
    """One loss of ``batch`` and its gradients: the loss and the norm of
    each gradient part (``param_tree`` order; a DTensor one in its
    parameter's placement, its sum of squares all-reduced)."""
    model.requires_grad_(True)
    loss = model.loss(batch)
    flat = env.pytree.parts(env.models.weights.param_tree(model))
    with model.mesh_context():
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
        norms = []
        for g, p in zip(gs, flat):
            if g is None:
                norms.append(0.0)
                continue
            sq = torch.sum(torch.square(env.tp.grad_to_param(g, p).float()))
            norms.append(float(sq.full_tensor() if env.tp.is_dtensor(sq)
                               else sq) ** 0.5)
    loss = loss.detach()
    del gs
    return (float(loss.full_tensor() if env.tp.is_dtensor(loss) else loss),
            np.array(norms))


def tp_serve_and_train(env: Env, model, case: dict, dev) -> dict:
    """Prefill ``case["tokens"]``, ``case["new"]`` greedy decode steps, one
    loss with its gradients (``loss_and_grad_norms``), and with
    ``case["train"]`` one train step (AdamW): the tokens, the first and
    last logits, the loss, each gradient part's norm, the step's loss and
    ``grad_norm``, and the seconds of each part."""
    tokens = torch.from_numpy(case["tokens"]).to(dev)
    b, s = tokens.shape
    caches = model.init_caches(b, s + case["new"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill({"tokens": tokens}, caches)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    first = logits.float().cpu().numpy()
    toks = [logits.argmax(-1)]
    t0 = time.perf_counter()
    for i in range(case["new"]):
        logits, caches = model.decode_step(toks[-1], caches, s + i)
        toks.append(logits.argmax(-1))
    torch.cuda.synchronize()
    out = {"tokens": torch.stack(toks).cpu().numpy(), "first": first,
           "last": logits.float().cpu().numpy(), "prefill_s": prefill_s,
           "decode_step_s": (time.perf_counter() - t0) / max(case["new"], 1)}
    del caches
    torch.cuda.empty_cache()
    batch = {k: torch.from_numpy(case[k]).to(dev)
             for k in ("batch_tokens", "batch_targets") if k in case}
    batch = {"tokens": batch.get("batch_tokens"),
             "targets": batch.get("batch_targets")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["loss"], out["grad_norms"] = loss_and_grad_norms(env, model, batch)
    torch.cuda.synchronize()
    out["grad_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    if case.get("train"):
        opt = env.optim.AdamW()
        state = env.train_step.init_state(model, opt)
        step = env.train_step.make_train_step(model, opt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t0
        out["step_loss"] = float(met["loss"])
        out["grad_norm"] = float(met["grad_norm"])
        del state
    return out


def tp_rank(rank: int, case: dict) -> dict:
    """One rank of phase 22's gloo worlds: the model placed on
    ``case["mesh"]`` by tensor parallelism (each leaf drawn from the
    generator one process draws from, this rank keeping its shard), then
    ``tp_serve_and_train``; launches and plain runs counted from 0."""
    env = Env()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.cuda.is_available() else torch.device("cpu"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    mesh = env.mesh.make_dev_mesh(case["mesh"][1])
    cfg = tp_config(env, case["arch"], case["layers"])
    gen = torch.Generator(device=dev).manual_seed(case["seed"])
    torch.cuda.reset_peak_memory_stats(dev)
    model = env.tp.distribute_model(env.models.LM(cfg, device="meta"), mesh,
                                    gen, device=dev)
    env.att.reset_launches()
    out = tp_serve_and_train(env, model, case, dev)
    launches, plain = dict(env.att.launches), dict(env.att.plain_runs)
    if case.get("moe"):
        del model
        torch.cuda.empty_cache()
        out["moe"] = moe_dense_fallback(env, mesh, dev)
    out.update(rank=rank, launches=launches, plain=plain,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               s=time.perf_counter() - t0,
               jax=[m for m in ("jax", "repro") if m in sys.modules])
    return out


def moe_dense_fallback(env: Env, mesh, dev) -> dict:
    """deepseek-moe-16b's MoE layer at full width on ``mesh``, whose
    ``model`` axis does not divide its 64 experts: the leaves placed by
    ``param_spec`` (replicated there) as DTensors, the rows by
    ``batch_input``, the layer run as the one-process layer on every rank
    (``models.moe._moe_mlp_dense``, the reference's dense path), against
    the one-process layer on plain tensors: each output row within 1e-4 of
    its max |y|, each gradient within 1e-3 of its leaf's max."""
    tp, sh = env.tp, env.sharding
    cfg, p, x, gy = moe_layer_inputs(env, dev)
    full = moe_leaves(p)
    for w in full:
        w.requires_grad_(True)
    x1 = x.clone().requires_grad_(True)
    y1 = env.models.moe.moe_mlp(p, x1, cfg)
    want = torch.autograd.grad((y1 * gy).sum(), full + [x1])
    y1 = y1.detach()

    def place(name, w):
        return tp.shard_input(w.detach(), mesh, sh.param_spec(name, w, mesh))
    dp = {k: place(k, p[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    dp["shared"] = {k: place(k, v) for k, v in p["shared"].items()}
    del p, full
    mine = moe_leaves(dp)
    for w in mine:
        w.requires_grad_(True)
    xd = tp.batch_input(x, mesh).requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tp.implicit_replication():
        y = env.models.moe.moe_mlp(dp, xd, cfg)
        got = torch.autograd.grad((y * tp.batch_input(gy, mesh)).sum(),
                                  mine + [xd])
        got = [g.full_tensor() for g in got]
        y = y.full_tensor().detach()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    row_err = float(((y - y1).abs().amax(1)
                     / y1.abs().amax(1).clamp_min(1e-30)).max())
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(
        1e-30)) for a, b in zip(got, want))
    placed = sorted({str(w.placements) for w in mine})
    if not (row_err <= 1e-4 and grad_err <= 1e-3):
        fail(f"MoE dense fallback on {tuple(mesh.shape)}: output rows "
             f"{row_err:.3g} of their max (bound 1e-4), gradients "
             f"{grad_err:.3g} of their max (bound 1e-3)")
    return {"row_err": row_err, "grad_err": grad_err, "s": s,
            "placements": placed, "tokens": x.shape[0]}


def tp_case(env: Env, arch: str, layers: int, mesh: tuple, prompt: tuple,
            new: int, batch: tuple, **kw) -> dict:
    cfg = tp_config(env, arch, layers)
    rng = np.random.default_rng(TP_SEED)
    case = {"arch": arch, "layers": layers, "mesh": mesh, "seed": TP_SEED,
            "new": new, "tokens": rng.integers(
                0, cfg.vocab_size, prompt).astype(np.int64), **kw}
    toks = rng.integers(0, cfg.vocab_size, (batch[0], batch[1] + 1))
    case["batch_tokens"] = toks[:, :-1].astype(np.int64)
    case["batch_targets"] = toks[:, 1:].astype(np.int64)
    return case


def tp_one_process(env: Env, case: dict, dev) -> dict:
    """``case`` in this process, without a mesh: the reference values of
    a tensor-parallel world."""
    cfg = tp_config(env, case["arch"], case["layers"])
    model = env.models.LM(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(case["seed"]))
    env.att.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    out = tp_serve_and_train(env, model, case, dev)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["launches"] = dict(env.att.launches)
    del model
    torch.cuda.empty_cache()
    return out


def hold_world(ranks: list, one: dict, need: tuple, ctx: str) -> dict:
    """Every rank against the one-process run: tokens identical, the first
    and last logits within ``TP_LOGIT_TOL``, the loss (and a train step's
    loss) within ``TP_LOSS_TOL`` relative, each gradient part's norm (and
    a train step's ``grad_norm``) within ``TP_GRAD_TOL`` relative (of at
    least 1e-6 of the largest); each kernel of ``need`` launched and no
    plain version run; no JAX."""
    errs = {"logits": 0.0, "loss": 0.0, "grads": 0.0}
    floor = 1e-6 * float(one["grad_norms"].max())
    for r in ranks:
        c = f"{ctx}, rank {r['rank']}"
        if r["jax"]:
            fail(f"{c}: imported {r['jax']}")
        if not np.array_equal(r["tokens"], one["tokens"]):
            fail(f"{c}: greedy tokens {r['tokens'].T.tolist()} differ from "
                 f"one process's {one['tokens'].T.tolist()}")
        for k in ("first", "last"):
            e = float(np.abs(r[k] - one[k]).max())
            if not np.isfinite(r[k]).all() or e > TP_LOGIT_TOL:
                fail(f"{c}: {k} logits off by {e} (bound {TP_LOGIT_TOL})")
            errs["logits"] = max(errs["logits"], e)
        for k in ("loss", "step_loss"):
            if k not in one:
                continue
            e = abs(r[k] - one[k]) / abs(one[k])
            if not np.isfinite(r[k]) or e > TP_LOSS_TOL:
                fail(f"{c}: {k} {r[k]} vs {one[k]} (rel {e:.3g}, bound "
                     f"{TP_LOSS_TOL})")
            errs["loss"] = max(errs["loss"], e)
        got, want = r["grad_norms"], one["grad_norms"]
        if got.shape != want.shape or not np.isfinite(got).all():
            fail(f"{c}: gradient norms {got.shape} vs {want.shape}")
        rel = np.abs(got - want) / np.maximum(want, floor)
        if "grad_norm" in one:
            rel = np.append(rel, abs(r["grad_norm"] - one["grad_norm"])
                            / one["grad_norm"])
        if rel.max() > TP_GRAD_TOL:
            i = int(rel.argmax())
            fail(f"{c}: gradient part {i}'s norm off by {rel[i]:.3g} "
                 f"relative (bound {TP_GRAD_TOL})")
        errs["grads"] = max(errs["grads"], float(rel.max()))
        if any(r["plain"].values()):
            fail(f"{c}: plain attention runs {r['plain']}")
        missing = [k for k in need if not r["launches"][k]]
        if missing:
            fail(f"{c}: no launch of {missing} ({r['launches']})")
    return errs


def phase_tensor_parallel(env: Env, dev) -> dict:
    """Phase 22: tensor and context parallelism over DTensor.  (a) the two
    kernel options against their plain versions (``phase22_kernels``);
    (b) a gloo world of 2 processes sharing the card, mesh (1, 2):
    qwen3-4b at full width and 8 layers, prefill, greedy decode steps, one
    loss with its gradients (each part's norm) and one train step against
    the same calls in one process; (c) a gloo world of 3, mesh (1, 3):
    qwen2-vl-7b at full width and 2 layers, the context-parallel prefill
    (``q_start``), decode steps over its sequence-sharded cache
    (``decode_attention_with_lse``) and one loss with its gradients (the
    backward with ``q_start``; each part's norm), against one process."""
    t0 = time.perf_counter()
    ka = phase22_kernels(env, dev)
    torch.cuda.empty_cache()
    b_case = tp_case(env, TP_ARCH, TRAIN_LAYERS, TP_MESH, TP_PROMPT, TP_NEW,
                     TP_TRAIN, train=True)
    b_one = tp_one_process(env, b_case, dev)
    t1 = time.perf_counter()
    b_ranks = env.world.spawn(tp_rank, TP_MESH[1], b_case, backend="gloo",
                              timeout_s=CP_TIMEOUT_S)
    b_s = time.perf_counter() - t1
    b_err = hold_world(b_ranks, b_one, ("flash_attention", "decode_attention",
                                        "flash_attention_backward"),
                       "phase 22 (b)")
    torch.cuda.empty_cache()
    c_case = tp_case(env, CP_ARCH, CP_LAYERS, CP_MESH, (1, CP_SEQ), CP_NEW,
                     (1, CP_SEQ), moe=True)
    c_one = tp_one_process(env, c_case, dev)
    t1 = time.perf_counter()
    c_ranks = env.world.spawn(tp_rank, CP_MESH[1], c_case, backend="gloo",
                              timeout_s=CP_TIMEOUT_S)
    c_s = time.perf_counter() - t1
    c_err = hold_world(c_ranks, c_one, ("flash_attention",
                                        "decode_attention_with_lse",
                                        "flash_attention_backward"),
                       "phase 22 (c)")
    for r in c_ranks[1:]:
        for k in ("flash_attention_q_start",
                  "flash_attention_backward_q_start"):
            if not r["launches"][k]:
                fail(f"phase 22 (c): rank {r['rank']} made no {k} launch "
                     f"({r['launches']})")

    def world_text(ranks, one):
        def step(r):
            return "" if "train_s" not in r else (
                f", train step {r['train_s'] * 1e3:.0f} ms "
                f"({one['train_s'] * 1e3:.0f})")
        return "; ".join(
            f"rank {r['rank']}: prefill {r['prefill_s'] * 1e3:.1f} ms (one "
            f"process {one['prefill_s'] * 1e3:.1f}), decode step "
            f"{r['decode_step_s'] * 1e3:.1f} ms "
            f"({one['decode_step_s'] * 1e3:.1f}), loss and gradients "
            f"{r['grad_s'] * 1e3:.0f} ms ({one['grad_s'] * 1e3:.0f}){step(r)}"
            f", peak {r['peak_gb']:.2f} GB (one process "
            f"{one['peak_gb']:.2f}), launches "
            f"{json.dumps({k: v for k, v in r['launches'].items() if v})}, "
            f"{r['s']:.1f} s" for r in ranks)
    log(f"phase 22 (b): gloo world of {TP_MESH[1]} processes sharing the "
        f"card, mesh {TP_MESH}, {TP_ARCH} at full width, {TRAIN_LAYERS} "
        f"layers: prefill {TP_PROMPT[0]} x {TP_PROMPT[1]}, {TP_NEW} greedy "
        f"decode steps (tokens == one process, logits max abs err "
        f"{b_err['logits']:.3g}, bound {TP_LOGIT_TOL}), one loss with its "
        f"gradients and one train step on {TP_TRAIN[0]} x {TP_TRAIN[1]} "
        f"(loss rel err {b_err['loss']:.3g}, bound {TP_LOSS_TOL}; gradient "
        f"parts' norms and grad_norm rel err {b_err['grads']:.3g}, bound "
        f"{TP_GRAD_TOL}), {b_s:.1f} s with the world's start; "
        + world_text(b_ranks, b_one))
    log(f"phase 22 (c): gloo world of {CP_MESH[1]} processes, mesh "
        f"{CP_MESH}, {CP_ARCH} at full width, {CP_LAYERS} layers (28 query "
        f"heads on a model axis of 3: context parallel): prefill of "
        f"{CP_SEQ} tokens, {CP_NEW} decode steps over the sequence-sharded "
        f"cache (tokens == one process, logits max abs err "
        f"{c_err['logits']:.3g}), one loss and its gradients (loss rel err "
        f"{c_err['loss']:.3g}, gradient parts' norms rel err "
        f"{c_err['grads']:.3g}), {c_s:.1f} s; " + world_text(c_ranks, c_one))
    log(f"phase 22 (c): {MESH_MOE_ARCH}'s MoE layer at full width on "
        f"{CP_MESH} (64 experts on a model axis of 3: the dense fallback, "
        f"the experts replicated) against the one-process layer, "
        f"{c_ranks[0]['moe']['tokens']} rows: " + "; ".join(
            f"rank {r['rank']}: output rows {r['moe']['row_err']:.3g} of "
            f"their max (bound 1e-4), gradients {r['moe']['grad_err']:.3g} "
            f"(bound 1e-3), {r['moe']['s'] * 1e3:.0f} ms, placements "
            f"{r['moe']['placements']}" for r in c_ranks))
    log(f"phase 22: {time.perf_counter() - t0:.1f} s")

    def total(ranks, key):
        return sum(r["launches"][key] for r in ranks)
    return {"kernels": ka, "launches": {
        "flash_attention_q_start": total(c_ranks, "flash_attention_q_start"),
        "flash_attention_backward_q_start": total(
            c_ranks, "flash_attention_backward_q_start"),
        "decode_attention_with_lse": total(c_ranks,
                                           "decode_attention_with_lse"),
        "tp": {k: total(b_ranks, k) + total(c_ranks, k)
               for k in ("flash_attention", "decode_attention",
                         "flash_attention_backward")}}}


# ------------------------------------------------------ the entry scripts

GOLDEN_EXAMPLES = ROOT / "tests" / "data" / "torch_golden_examples.json"
ENTRY_APPS = ("kmeans", "cfd")
ENTRY_SERVE = dict(batch=4, prompt_len=32, max_new=8, split="auto",
                   rounds=6)
ENTRY_SERVE_LAYERS = 4           # qwen3-4b at full width, depth cut 36 -> 4
ENTRY_TRAIN_STEPS = 60           # torch_train_lm's default
ENTRY_TRAIN_CKPT = ROOT / "build" / "chip_smoke_train_lm"
ENTRY_PROFILE = "cfd:Morpheus-ALL:32:36"
# the wrappers the entry scripts must launch, by counter (no script reads
# a page back: ``Engine.run`` prefills whatever the pool holds, and the
# quickstart only looks keys up, so ``read_rows`` is not on their paths)
ENTRY_NEED = {"scan": ("conv_scan", "ext_scan"),
              "pool": ("lookup_fill", "bloom_query", "bloom_record",
                       "page_write"),
              "att": ("flash_attention", "flash_attention_backward",
                      "decode_attention")}
# kernels-line rows and the wrappers whose phase-23 launches each reports
ENTRY_ROWS = {"conv_scan": ("scan", ("conv_scan",)),
              "ext_scan": ("scan", ("ext_scan",)),
              "tag_lookup": ("pool", ("lookup_fill", "tag_lookup")),
              "bloom_query": ("pool", ("bloom_query",)),
              "bloom_record": ("pool", ("bloom_record",)),
              "bdi_compress": ("pool", ("page_write", "bdi_compress")),
              "bdi_decompress": ("pool", ("read_rows", "bdi_decompress")),
              "gather_blocks": ("pool", ("read_rows", "gather_blocks",
                                         "cached_block_read")),
              "decode_attention": ("att", ("decode_attention",)),
              "flash_attention": ("att", ("flash_attention",)),
              "flash_attention_backward": ("att",
                                           ("flash_attention_backward",))}


def load_script(rel: str):
    """A twin of an entry script (``examples/torch_*.py``,
    ``tools/torch_*.py``) as a module, loaded by path."""
    import importlib.util
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location("_entry_" + path.stem,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def close_rel(got: float, want: float) -> bool:
    return abs(got - want) <= FLOAT_RTOL * abs(want)


def hold_replay(got: dict, want: dict, ctx: str) -> float:
    """The replay's rows against the reference's golden: splits and
    integer Stats identical, normalized time, hit rate and MPKI within
    ``FLOAT_RTOL`` relative; the largest relative error."""
    worst = 0.0
    for part in ("rows", "ablation"):
        if list(got[part]) != list(want[part]):
            fail(f"{ctx}: {part} {list(got[part])} vs {list(want[part])}")
        for k, w in want[part].items():
            g = got[part][k]
            if (g["n_compute"], g["n_cache"], g["stats"]) != \
                    (w["n_compute"], w["n_cache"], w["stats"]):
                fail(f"{ctx} {part} {k}: split {g['n_compute']}+"
                     f"{g['n_cache']} Stats {g['stats']} vs the reference's "
                     f"{w['n_compute']}+{w['n_cache']} {w['stats']}")
            for f in ("norm_time", "hit_rate", "mpki"):
                if not close_rel(g[f], w[f]):
                    fail(f"{ctx} {part} {k}: {f} {g[f]} vs {w[f]}")
                if w[f]:
                    worst = max(worst, abs(g[f] - w[f]) / abs(w[f]))
    return worst


def entry_counts(env: Env) -> dict:
    return {"scan": dict(env.scan.launches), "pool": dict(env.pool.launches),
            "att": dict(env.att.launches)}


def entry_plain(env: Env) -> dict:
    return {"scan": dict(env.scan.plain_runs),
            "pool": dict(env.pool.plain_runs),
            "att": dict(env.att.plain_runs)}


def phase_entry_scripts(env: Env, dev) -> dict:
    """Phase 23: the twins of the repo's entry scripts, loaded by path and
    run on the card with the launch counts from 0: (a) the paper replay
    (``examples/torch_morpheus_replay.py``) of kmeans and cfd at its
    default 30 000 requests against the reference's golden rows; (b) the
    quickstart's pool, model and simulator parts, the pool stats and
    the simulator's runs against the golden; (c) ``torch_serve_morpheus
    .run`` of qwen3-4b at full width, depth cut to 4, ``--split auto`` for
    6 rounds (tokens/s, the governor's decisions, tokens identical with
    the pool on and off); (d) ``torch_train_lm`` ``--model-100m``, 60
    steps with checkpoints and the restart; (e) ``torch_profile_cell
    engine`` of cfd:Morpheus-ALL:32:36 with both scan kernels' device ms.
    Every wrapper of ``ENTRY_NEED`` launched, no plain version run."""
    t0 = time.perf_counter()
    golden = json.loads(GOLDEN_EXAMPLES.read_text())
    env.scan.reset_launches()
    env.pool.reset_launches()
    env.att.reset_launches()
    plain0 = entry_plain(env)       # engine_scan's plain runs are not reset
    out = {"replay": {}}
    replay = load_script("examples/torch_morpheus_replay.py")
    for app in ENTRY_APPS:
        t1 = time.perf_counter()
        got = replay.run(app, golden["replay_length"])
        s = time.perf_counter() - t1
        err = hold_replay(got, golden["replay"][app], f"phase 23 (a) {app}")
        out["replay"][app] = {"s": s, "err": err, "rows": {
            k: f"{r['n_compute']}c+{r['n_cache']}$ {r['norm_time']:.3f}"
            for k, r in got["rows"].items()}}

    qs = load_script("examples/torch_quickstart.py")
    t1 = time.perf_counter()
    pool = qs.pool_part()
    want = golden["quickstart"]["pool"]
    if {k: v for k, v in pool.items() if isinstance(v, int)} != \
            {k: v for k, v in want.items() if isinstance(v, int)} or \
            not close_rel(pool["time_ns"], want["time_ns"]):
        fail(f"phase 23 (b): quickstart pool stats {pool} vs {want}")
    model = qs.model_part()
    if not (model["finite"] and math.isfinite(model["loss"])):
        fail(f"phase 23 (b): quickstart model part {model}")
    sim = qs.sim_part()
    for name, w in golden["quickstart"]["sim"].items():
        g = sim[name]
        if g["stats"] != w["stats"] or not close_rel(g["exec_time_s"],
                                                     w["exec_time_s"]):
            fail(f"phase 23 (b): quickstart {name} {g} vs {w}")
    out["quickstart"] = {"s": time.perf_counter() - t1, "loss": model["loss"],
                         "speedup": sim["BL"]["exec_time_s"]
                         / sim["Morpheus-ALL"]["exec_time_s"]}

    serve = load_script("examples/torch_serve_morpheus.py")
    cfg = dataclasses.replace(env.configs.get(SERVE_ARCH),
                              num_layers=ENTRY_SERVE_LAYERS)
    lines = []
    t1 = time.perf_counter()
    sv = serve.run(cfg, log=lines.append, **ENTRY_SERVE)
    serve_s = time.perf_counter() - t1
    if not sv["match"] or sv["tokens_on"] != sv["tokens_off"]:
        fail("phase 23 (c): tokens differ with the Morpheus pool on and off")
    torch.cuda.empty_cache()
    rounds = [r for r in sv["rounds"] if "report" in r]
    out["serve"] = {"s": serve_s,
                    "tokens_per_s": [r["tokens_per_s"] for r in rounds],
                    "decisions": [ln.strip() for ln in lines
                                  if "governor epoch" in ln],
                    "pool_stats": sv["pool_stats"]}

    tr = load_script("examples/torch_train_lm.py")
    import shutil
    shutil.rmtree(ENTRY_TRAIN_CKPT, ignore_errors=True)
    args = type("Args", (), dict(arch=SERVE_ARCH, full=False,
                                 model_100m=True))
    tcfg = tr.build_cfg(args)
    train_lines = []
    tt = tr.run(tcfg, steps=ENTRY_TRAIN_STEPS, ckpt_dir=str(ENTRY_TRAIN_CKPT),
                log=train_lines.append)
    shutil.rmtree(ENTRY_TRAIN_CKPT, ignore_errors=True)
    if tt["resumed_from"] != ENTRY_TRAIN_STEPS or \
            not tt["losses"][-1] < tt["losses"][0]:
        fail(f"phase 23 (d): {train_lines[-3:]}")
    out["train"] = {k: tt[k] for k in ("name", "ms_per_step", "seconds",
                                       "resumed_from", "resumed_steps_run",
                                       "resumed_seconds")}
    out["train"].update(first=tt["losses"][0], last=tt["losses"][-1])
    torch.cuda.empty_cache()

    prof = load_script("tools/torch_profile_cell.py")
    pe = prof.profile_engine(ENTRY_PROFILE, 8)
    ms = pe["scan_device_ms"]
    if not all(ms[k] > 0 for k in prof.SCAN_KERNELS):
        fail(f"phase 23 (e): the profile of {ENTRY_PROFILE} lists no "
             f"{[k for k in prof.SCAN_KERNELS if not ms[k]]} ({ms})")
    out["profile"] = {"scan_device_ms": ms, "ops": [r[0] for r in pe["ops"]],
                      "flops": pe["flops"], "bytes": pe["bytes"]}

    counts, plain = entry_counts(env), entry_plain(env)
    missing = [f"{c}.{w}" for c, ws in ENTRY_NEED.items() for w in ws
               if not counts[c][w]]
    ran_plain = {c: {k: v - plain0[c][k] for k, v in plain[c].items()
                     if v != plain0[c][k]} for c in plain}
    if missing or any(ran_plain.values()):
        fail(f"phase 23: no launch of {missing} or plain runs {ran_plain} "
             f"(launches {counts})")
    out["launches"] = counts
    out["s"] = time.perf_counter() - t0
    log("phase 23 (a): torch_morpheus_replay at "
        f"{golden['replay_length']} requests == the reference's golden "
        "(splits and integer Stats identical, floats within "
        f"{FLOAT_RTOL}): " + "; ".join(
            f"{app} {v['s']:.1f} s, max rel err {v['err']:.3g}, "
            + ", ".join(f"{k} {r}" for k, r in v["rows"].items())
            for app, v in out["replay"].items()))
    q = out["quickstart"]
    log(f"phase 23 (b): torch_quickstart: pool stats == golden, simulator "
        f"times within {FLOAT_RTOL} (speedup {q['speedup']:.2f}x), reduced "
        f"{SERVE_ARCH} train step loss {q['loss']:.4f}, {q['s']:.1f} s")
    v = out["serve"]
    log(f"phase 23 (c): torch_serve_morpheus.run {SERVE_ARCH} at full "
        f"width, {ENTRY_SERVE_LAYERS} layers, batch {ENTRY_SERVE['batch']}, "
        f"prompt {ENTRY_SERVE['prompt_len']}, +{ENTRY_SERVE['max_new']}, "
        f"--split auto, {ENTRY_SERVE['rounds']} rounds: tokens/s "
        + ", ".join(f"{x:.1f}" for x in v["tokens_per_s"])
        + f"; decisions: {' / '.join(v['decisions'])}; tokens identical "
        f"with the pool on and off; {v['s']:.1f} s with the weights drawn")
    tr_ = out["train"]
    log(f"phase 23 (d): torch_train_lm --model-100m ({tr_['name']}): "
        f"{ENTRY_TRAIN_STEPS} steps, loss {tr_['first']:.4f} -> "
        f"{tr_['last']:.4f}, {tr_['ms_per_step']:.1f} ms a step (the call's "
        f"wall over its steps, checkpoints and set-up included), resumed "
        f"at step {tr_['resumed_from']} for {tr_['resumed_steps_run']} "
        f"more in {tr_['resumed_seconds']:.1f} s")
    log(f"phase 23 (e): torch_profile_cell engine {ENTRY_PROFILE}: ops "
        f"{out['profile']['ops']}, scan kernels' device ms " + ", ".join(
            f"{k} {ms[k]:.4f}" for k in prof.SCAN_KERNELS)
        + f" (profiled window {ms['window']})")
    log(f"phase 23: launches {json.dumps(counts)}, no plain run; "
        f"{out['s']:.1f} s")
    return out


# ------------------------------------------------------- the bf16 path

GOLDEN_BF16 = ROOT / "tests" / "data" / "torch_golden_bf16.json"
BF16_ARCH = "gemma3-27b"         # as published: bf16, 62 layers
BF16_LAYERS = 62
BF16_SERVE = dict(batch=4, prompt=2048, new=16)   # the window of 1024 bites
# (b): the layers held to their f32 twins, each by the CPU reference's
# one-layer error of golden cell B's layer of its kind (a local prefix
# layer; the global layer closing a block)
BF16_TWINS = {0: "0", 7: "7", 61: "7"}
BF16_TRAIN_LAYERS, BF16_TRAIN_STEPS = 8, 8      # (c): 4.71 B parameters
BF16_TWIN_STEPS = 3              # (c): the 2-layer run against its f32 twin
BF16_RATIO, BF16_FLOOR, BF16_GREEDY = 2.0, 1e-3, 4.0  # test_torch_bf16.py
BF16_TREE_THREADS = 2            # host threads drawing cells A and B
BF16_PEAK = 989e12               # the H100's dense bf16 tensor-core peak


def bf16_config(env: Env, layers: int = 0):
    """gemma3-27b as published (bf16), its depth cut to ``layers`` (0:
    all 62)."""
    cfg = env.configs.get(BF16_ARCH)
    if cfg.param_dtype != "bfloat16":
        fail(f"phase 24: {BF16_ARCH} is not bf16 ({cfg.param_dtype})")
    if not layers:
        return cfg
    return dataclasses.replace(cfg, name=f"{cfg.name}-{layers}l",
                               num_layers=layers)


def bf16_want(env: Env, model, prefills: int, steps: int) -> dict:
    """``want_launches`` of a bf16 model, with every flash launch on
    ``flash_kernel_bf16`` and every decode on the tensor-core
    ``decode_partial_kernel_tc``."""
    want = want_launches(model, prefills, steps)
    if want["flash_attention_bf16"] != want["flash_attention"] or \
            want["decode_attention_tc"] != want["decode_attention"]:
        fail(f"phase 24: {model.cfg.name} would not run the bf16 tensor-core "
             f"kernels ({want})")
    return want


def weights_crc(tree) -> int:
    """``tests/test_torch_golden_bf16.py``'s crc32 of a tree of host
    tensors (each leaf's bf16 bits, ``pytree.flatten`` order)."""
    from repro_torch.pytree import flatten
    crc = 0
    for _, t in flatten(tree):
        a = t.contiguous().view(torch.int16).numpy()
        crc = zlib.crc32(np.ascontiguousarray(a).view(np.uint8), crc)
    return crc


def bf16_hold_rows(rows: np.ndarray, cell: dict, batch: int, ctx: str
                   ) -> dict:
    """``tests/test_torch_golden_bf16.py``'s ``check_cell``: in each phase
    (the prefill, each step) the port's largest |logit - oracle's| over
    the stored indices at most BF16_RATIO x the reference's (the larger
    lowering's) plus BF16_FLOOR x max |oracle|; greedy tokens equal where
    the oracle's top-2 margin exceeds BF16_GREEDY x the row's larger
    error."""
    want = cell["rows"]
    if len(rows) != len(want) or not np.isfinite(rows).all():
        fail(f"{ctx}: {len(rows)} logits rows (golden {len(want)}) or not "
             f"finite")
    out, sure = {}, 0
    for ph in range(len(want) // batch):
        label = "prefill" if ph == 0 else f"step {ph - 1}"
        p_err = r_err = top = 0.0
        for i in range(ph * batch, (ph + 1) * batch):
            w = want[i]
            idx, o = np.asarray(w["top_idx"]), np.asarray(w["top_val"])
            p_row = float(np.abs(rows[i][idx].astype(np.float64) - o).max())
            r_row = max(float(np.abs(np.asarray(w[k]) - o).max())
                        for k in ("bf16", "bf16_no_excess"))
            p_err, r_err = max(p_err, p_row), max(r_err, r_row)
            top = max(top, w["max_abs"])
            if w["margin"] > BF16_GREEDY * max(p_row, r_row):
                sure += 1
                if int(np.argmax(rows[i])) != w["greedy"]:
                    fail(f"{ctx} {label} row {i}: greedy "
                         f"{int(np.argmax(rows[i]))}, the oracle's "
                         f"{w['greedy']} (margin {w['margin']:.4g})")
        lim = BF16_RATIO * r_err + BF16_FLOOR * top
        if p_err > lim:
            fail(f"{ctx} {label}: the port's bf16 is {p_err:.4g} from the "
                 f"f32 oracle, the reference's {r_err:.4g} (limit "
                 f"{lim:.4g})")
        out[label] = [p_err, r_err, lim]
    if not sure:
        fail(f"{ctx}: no greedy token compared")
    out["greedy_rows"] = sure
    return out


def bf16_golden_cell(env: Env, name: str, golden: dict, tree, dev) -> dict:
    """(a) one cell of ``tests/data/torch_golden_bf16.json`` on the card:
    the port's bf16 LM on the cell's weights (drawn by a host thread,
    checked by their crc32), its prompts and the oracle's tokens."""
    c, cell = golden["cells_config"][name], golden["cells"][name]
    common = golden["common"]
    cfg = bf16_config(env, c["num_layers"])
    if cfg.param_count()[0] != cell["params"]:
        fail(f"golden bf16 {name}: {cfg.param_count()[0]} parameters, "
             f"golden {cell['params']}")
    crc = weights_crc(tree)
    if crc != cell["weights_crc32"]:
        fail(f"golden bf16 {name}: weights crc32 {crc}, golden "
             f"{cell['weights_crc32']}")
    t0 = time.perf_counter()
    model = env.models.LM(cfg, device=dev)
    env.models.params_from_numpy(model, tree)
    rng = np.random.default_rng(common["input_seed"])
    prompts = rng.integers(0, cfg.vocab_size, (c["batch"], c["prompt"])
                           ).astype(np.int32)
    teacher = np.asarray(cell["teacher"], np.int32)
    caches = model.init_caches(c["batch"], c["prompt"] + c["steps"])
    logits, caches = model.prefill(
        {"tokens": torch.from_numpy(prompts).to(dev)}, caches)
    rows = [logits]
    for t, tok in enumerate(teacher):
        logits, caches = model.decode_step(torch.from_numpy(tok).to(dev),
                                           caches, c["prompt"] + t)
        rows.append(logits)
    rows = torch.cat(rows).float().cpu().numpy()
    out = {"params": cell["params"], "layers": c["num_layers"],
           "batch": c["batch"], "prompt": c["prompt"],
           "err": bf16_hold_rows(rows, cell, c["batch"],
                                 f"golden bf16 {name}"),
           "s": time.perf_counter() - t0}
    del model, caches
    torch.cuda.empty_cache()
    return out


class LayerTap:
    """While entered, keeps the input and output of the first
    ``prefill_layer`` call of each layer in ``layers`` (an engine round's
    prefill)."""

    def __init__(self, model, layers):
        self.model, self.layers, self.seen = model, set(layers), {}

    def __enter__(self):
        real = self.model.prefill_layer

        def tap(li, x, cache, enc_out=None, layer=None):
            y = real(li, x, cache, enc_out, layer)
            if li in self.layers and li not in self.seen:
                self.seen[li] = (x.detach().clone(), y.detach().clone())
            return y
        self.model.prefill_layer = tap
        return self

    def __exit__(self, *exc):
        del self.model.prefill_layer


def bf16_twin(env: Env, model, li: int, x: torch.Tensor, y: torch.Tensor,
              dev) -> float:
    """Layer ``li``'s output error against its f32 twin on the card (the
    layer's weights widened, an f32 cache, the f32 kernels) at the input
    the bf16 run gave it, relative to the twin's largest |output|."""
    W, A = env.models.weights, env.models.attention
    cfg, spec = model.cfg, model.specs[li]
    twin = env.models.transformer.Layer(
        W.layer_inits(cfg, spec, cross=W.has_cross(cfg, li)), torch.float32,
        dev)
    for (n, p), (_, q) in zip(twin.named_parameters(),
                              model.layers[li].named_parameters()):
        p.data.copy_(q.data)
    cache = A.init_kv_cache(cfg, spec, x.shape[0], x.shape[1],
                            torch.float32, dev)
    with torch.no_grad():
        y32 = model.prefill_layer(li, x.float(), cache, None, layer=twin)
    err = float((y.float() - y32).abs().max() / y32.abs().max())
    del twin, cache, y32
    return err


def bf16_serving(env: Env, dev, golden: dict) -> dict:
    """(b) gemma3-27b as published, all 62 layers in bf16 (weights drawn on
    the card), served by ``Engine``: BF16_SERVE's prompts, the same round
    again, then ``Engine(morpheus=False)``; the tokens of the three equal,
    each round's attention launches the model's, every one of them on the
    bf16 tensor-core kernels; layers 0, 7 and 61 of the first prefill
    against their f32 twins; every attention call of the path against
    its plain version."""
    att, se = env.att, env.serving
    cfg = bf16_config(env)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = env.models.LM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    if len(model.layers) != BF16_LAYERS or model.dtype != torch.bfloat16:
        fail(f"phase 24: not gemma3-27b as published ({cfg})")
    b, s, new = BF16_SERVE["batch"], BF16_SERVE["prompt"], BF16_SERVE["new"]
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s))
    max_len = s + new
    eng = se.Engine(model, max_len=max_len)
    rounds = [("round 1", eng), ("round 2", eng),
              ("morpheus off", se.Engine(model, max_len=max_len,
                                         morpheus=False))]
    results = []
    with StepTimer(model) as timer, LayerTap(model, BF16_TWINS) as tap, \
            PathCalls(env.ops, ATT_WRAPPERS) as calls:
        for name, e in rounds:
            reqs = [se.Request(i, p.tolist(), new)
                    for i, p in enumerate(prompts)]
            att.reset_launches()
            reused = e.pages_reused
            timer.reset()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rep = e.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            got, plain = dict(att.launches), dict(att.plain_runs)
            want = bf16_want(env, model, 1, rep.steps)
            if got != want or any(plain.values()):
                fail(f"phase 24 serving {name}: attention launches {got}, "
                     f"expected {want}; plain runs {plain}")
            results.append(dict(
                round=name, wall_s=wall, prefill_s=timer.prefill_s,
                decode_ms_step=1e3 * timer.decode_s / max(timer.steps, 1),
                steps=rep.steps, tokens_per_s=rep.generated / wall,
                pages_reused=e.pages_reused - reused, launches=got,
                tokens=[r.out_tokens for r in reqs]))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    toks = [r.pop("tokens") for r in results]
    if any(len(t) != new or min(t) < 0 or max(t) >= cfg.padded_vocab()
           for t in toks[0]):
        fail("phase 24 serving: tokens out of range or short")
    if not toks[0] == toks[1] == toks[2]:
        fail("phase 24 serving: tokens differ across round 1, round 2 and "
             "Morpheus off")
    if results[1]["pages_reused"] == 0:
        fail("phase 24 serving: round 2 reused no page")
    layer_err = golden["cells"]["B"]["layer_err"]
    twins = {}
    for li, ref in BF16_TWINS.items():
        x, y = tap.seen.pop(li)
        err = bf16_twin(env, model, li, x, y, dev)
        lim = BF16_RATIO * layer_err[ref] + BF16_FLOOR
        twins[li] = dict(err=err, ref_err=layer_err[ref], limit=lim,
                         kind=model.specs[li].attn_kind)
        if err > lim:
            fail(f"phase 24 serving: layer {li} ({twins[li]['kind']}) is "
                 f"{err:.4g} (relative) from its f32 twin, the reference's "
                 f"layer {ref} {layer_err[ref]:.4g} on the CPU (limit "
                 f"{lim:.4g})")
        del x, y
    del tap
    from repro_torch.launch import dryrun as D
    meta = env.models.LM(cfg, device="meta")
    flops = D.count_prefill(meta, {"tokens": torch.empty(
        (b, s), dtype=torch.int32, device="meta")},
        meta.init_caches(b, max_len)).flops
    prefill_s = float(np.median([r["prefill_s"] for r in results]))
    decode_ms = float(np.median([r["decode_ms_step"] for r in results]))
    bound_ms = weight_bytes / kernel_work().CHIP.hbm_Bps * 1e3
    out = dict(arch=cfg.name, layers=len(model.layers), params=n_params,
               weight_gb=weight_bytes / 1e9, init_s=init_s, peak_gb=peak_gb,
               rounds=results, twins=twins, prefill_flops=flops, prefill_s=prefill_s,
               prefill_mfu=flops / (prefill_s * BF16_PEAK),
               decode_ms=decode_ms, decode_bound_ms=bound_ms,
               decode_bound_share=bound_ms / decode_ms,
               launches={k: sum(r["launches"][k] for r in results)
                         for k in results[0]["launches"]})
    del model, eng, rounds
    torch.cuda.empty_cache()
    # the path's calls replayed once the 54 GB model is freed: the plain
    # flash at (4, 2048, 32, 128) holds GBs of logits
    out["path"] = phase_attention_path(env, calls, "phase 24 (b): the bf16 "
                                       "serving path")
    return out


def bf16_training(env: Env, dev, tree_a, golden: dict) -> dict:
    """(c) bf16 training at full width: ``train.loop.train`` of
    gemma3-27b at BF16_TRAIN_LAYERS layers (bf16 weights and gradients,
    AdamW's f32 moments), launches from 0, every flash forward and
    backward on the bf16 kernels; then ``bf16_twins``."""
    from repro_torch.launch import dryrun as D
    att = env.att
    cfg = bf16_config(env, BF16_TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    att.reset_launches()
    losses, _, ms, _ = train_run(env, cfg, dev, BF16_TRAIN_STEPS)
    torch.cuda.synchronize()
    counts, plain = dict(att.launches), dict(att.plain_runs)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    n, steps = BF16_TRAIN_LAYERS, BF16_TRAIN_STEPS
    # every layer's forward once, the blocks' (not the prefix's) again in
    # the backward (remat)
    fwd = steps * (2 * n - len(cfg.prefix_layers))
    want = att_want(att, flash_attention=fwd, flash_attention_bf16=fwd,
                    flash_attention_backward=n * steps,
                    flash_attention_backward_bf16=n * steps)
    if counts != want or any(plain.values()):
        fail(f"phase 24 training: attention launches {counts} (expected "
             f"{want}), plain runs {plain}")
    if not losses[-1] < losses[0]:
        fail(f"phase 24 training: the loss did not fall ({losses})")
    torch.cuda.empty_cache()
    step_ms = float(np.median(ms[1:]))
    t = torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32,
                    device="meta")
    flops = D.count_train(env.models.LM(cfg, device="meta"),
                          {"tokens": t, "targets": t}).flops
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return dict(arch=cfg.name, params=cfg.param_count()[0], losses=losses,
                step_ms=step_ms, first_step_ms=ms[0],
                tokens_per_s=tokens / step_ms * 1e3, peak_gb=peak_gb,
                flops=flops, mfu=flops / (step_ms * 1e-3 * BF16_PEAK),
                launches=counts, twins=bf16_twins(env, dev, tree_a, golden))


def bf16_twins(env: Env, dev, tree_a, golden: dict) -> dict:
    """(c) golden cell A's model and weights (2 layers) trained
    BF16_TWIN_STEPS AdamW steps (``train.loop.train``'s settings) on the
    golden's batch three ways: in bf16; its f32 twin; and the f32 twin
    with its weights rounded to bf16 after each update (bf16 storage, f32
    compute), as a bf16 model's AdamW stores them (the reference's
    rounds alike).  Step 0's loss (before any update) in bf16 against the
    f32 twin's, and every step's against the bf16-storage twin's, within
    BF16_RATIO x the CPU reference's step-0 bf16 loss error on the same
    weights and batch (``train_cell``) plus 1e-4: bf16 compute.  The gap
    to the pure f32 twin after updates is bf16 storage's, reported."""
    tc = golden["train_cell"]
    cfg = bf16_config(env, golden["cells_config"][tc["cell"]]["num_layers"])
    batch = {k: torch.tensor(v, dtype=torch.int32, device=dev)
             for k, v in tc["batch"].items()}
    steps = BF16_TWIN_STEPS

    def run(dtype: str, storage=None) -> list:
        model = env.models.LM(dataclasses.replace(cfg, param_dtype=dtype),
                              device=dev)
        opt = env.optim.AdamW(
            learning_rate=3e-4,
            schedule=env.optim.cosine_with_warmup(min(20, steps // 10 + 1),
                                                  steps))
        state = env.train_step.init_state(model, opt, tree_a)
        step = env.train_step.make_train_step(model, opt)
        losses = []
        for _ in range(steps):
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            if storage is not None:
                with torch.no_grad():
                    for p in model.parameters():
                        p.copy_(p.to(storage))
        del model, state, step
        torch.cuda.empty_cache()
        return losses

    l16 = run("bfloat16")
    l32 = run("float32")
    store = run("float32", torch.bfloat16)
    lim = BF16_RATIO * tc["gap"] + 1e-4
    compute = [abs(a - b) for a, b in zip(l16, store)]
    if not all(math.isfinite(x) for x in l16 + l32 + store):
        fail(f"phase 24 training twins: a loss is not finite ({l16}, {l32}, "
             f"{store})")
    if abs(l16[0] - l32[0]) > lim or max(compute) > lim:
        fail(f"phase 24 training twins: bf16 losses {l16}, the f32 twin's "
             f"{l32}, with bf16 storage {store} (limit {lim:.4g}: twice the "
             f"CPU reference's step-0 bf16 error {tc['gap']:.4g})")
    return dict(bf16=l16, f32=l32, f32_bf16_storage=store, limit=lim,
                cpu_gap=tc["gap"], compute_diff=compute,
                storage_diff=[abs(a - b) for a, b in zip(store, l32)],
                f32_diff=[abs(a - b) for a, b in zip(l16, l32)],
                reduced_gap=golden["train_gap"]["gap"])


def bf16_backward_path(env: Env, dev) -> dict:
    """The bf16 flash backward at (c)'s shape (B 8, S = T 128, H 32/16, hd
    128, causal, a local layer's window 1024) against its plain version,
    from the forward's log-sum-exp, timed with its bound and SDPA's
    backward."""
    att = env.att
    rng = np.random.default_rng(24)
    dt = torch.bfloat16
    q = att_randn(rng, (TRAIN_BATCH, TRAIN_SEQ, 32, 128), dt, dev)
    k, v = (att_randn(rng, (TRAIN_BATCH, TRAIN_SEQ, 16, 128), dt, dev)
            for _ in range(2))
    kw = dict(causal=True, window=1024, softcap=0.0, scale=None)
    o, lse = att.flash_attention_with_lse(q, k, v, **kw)
    do = att_randn(rng, tuple(o.shape), dt, dev)
    err = max(att_close(g, w, BWD_TOL[dt], f"phase 24 bf16 backward {n}")
              for n, g, w in zip("qkv", att.flash_attention_backward(
                  q, k, v, o, do, lse, **kw),
                  att.flash_attention_backward_plain(q, k, v, o, do, lse,
                                                     **kw)))
    out = dict(err=err, shape=[list(x.shape) for x in (q, k, v)],
               **times(lambda: att.flash_attention_backward(
                   q, k, v, o, do, lse, **kw),
                   lambda: att.flash_attention_backward_plain(
                       q, k, v, o, do, lse, **kw), 20, 3),
               bound=bwd_bound(q, k, v, kw))
    lib = sdpa_backward(q, k, v, do, kw)     # autograd: no graph
    out["library_ms"] = timed_cuda(lib, 5)
    return out


def phase_bf16(env: Env, dev) -> dict:
    """Phase 24: the bf16 path, gemma3-27b as published.  (a) the two
    cells of ``tests/data/torch_golden_bf16.json``, whose weights host
    threads draw meanwhile; (b) serving at 62 layers; (c) training at
    BF16_TRAIN_LAYERS layers and the 2-layer runs against their f32
    twins; and the bf16 backward at (c)'s shape against its plain
    version."""
    golden = json.loads(GOLDEN_BF16.read_text())
    common = golden["common"]
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(BF16_TREE_THREADS)
    trees = {name: pool.submit(
        env.models.seeded_params,
        bf16_config(env, golden["cells_config"][name]["num_layers"]),
        common["seed"]) for name in golden["cells"]}
    serving = bf16_serving(env, dev, golden)
    serve_s = time.perf_counter() - t0
    cells = {name: bf16_golden_cell(env, name, golden,
                                    trees[name].result(), dev)
             for name in golden["cells"]}
    tree_a = trees.pop("A").result()
    trees.clear()
    pool.shutdown()
    training = bf16_training(env, dev, tree_a, golden)
    del tree_a
    backward = bf16_backward_path(env, dev)
    wall = time.perf_counter() - t0
    s, tr, tw = serving, training, training["twins"]
    log("phase 24 (a): golden bf16 cells (gemma3-27b at full width, bf16) "
        "on the card hold the f32 oracle as the reference does "
        "(|port - oracle| <= 2 x |reference - oracle| + 1e-3 max|oracle| "
        "a phase): " + "; ".join(
            f"cell {n} ({c['layers']} layers, {c['params']} parameters, "
            f"{c['batch']} x {c['prompt']}): " + ", ".join(
                f"{k} {v[0]:.4g} (reference {v[1]:.4g}, limit {v[2]:.4g})"
                for k, v in c["err"].items() if k != "greedy_rows")
            + f", greedy rows compared {c['err']['greedy_rows']}, "
            f"{c['s']:.1f} s" for n, c in cells.items()))
    log(f"phase 24 (b): serving {s['arch']} as published ({s['layers']} "
        f"layers, {s['params']} parameters, {s['weight_gb']:.2f} GB bf16, "
        f"drawn on the card in {s['init_s']:.2f} s), {BF16_SERVE['batch']} x "
        f"{BF16_SERVE['prompt']}-token prompts, {BF16_SERVE['new']} new "
        f"tokens; round 1, round 2 and Morpheus off give the same tokens: "
        + "; ".join(f"{r['round']} {r['wall_s']:.3f} s, prefill "
                    f"{r['prefill_s']:.3f} s, decode {r['decode_ms_step']:.2f}"
                    f" ms a step x {r['steps']}, {r['tokens_per_s']:.1f} "
                    f"tokens/s, pages reused {r['pages_reused']}"
                    for r in s["rounds"])
        + f"; attention launches {json.dumps(s['launches'])}, plain runs 0; "
        f"peak memory {s['peak_gb']:.2f} GB; prefill {s['prefill_flops']:.4g}"
        f" FLOPs (op_cost) in {s['prefill_s']:.3f} s: MFU "
        f"{s['prefill_mfu']:.3f} of 989 TFLOP/s; decode step "
        f"{s['decode_ms']:.2f} ms against its weights' bytes bound "
        f"{s['decode_bound_ms']:.2f} ms (share {s['decode_bound_share']:.3f}"
        f"); layers against their f32 twins: " + ", ".join(
            f"{li} ({t['kind']}) {t['err']:.4g} (the reference's "
            f"{t['ref_err']:.4g}, limit {t['limit']:.4g})"
            for li, t in s["twins"].items()))
    log(f"phase 24 (c): training {tr['arch']} ({tr['params']} parameters, "
        f"bf16, f32 moments) by train.loop.train, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}: loss {tr['losses'][0]:.4f} -> {tr['losses'][-1]:.4f}"
        f" over {BF16_TRAIN_STEPS} steps, {tr['step_ms']:.1f} ms a step "
        f"(median of steps 2-{BF16_TRAIN_STEPS}; the first "
        f"{tr['first_step_ms']:.0f} ms), {tr['tokens_per_s']:.0f} tokens/s, "
        f"MFU {tr['mfu']:.3f} ({tr['flops']:.4g} FLOPs a step, op_cost, at "
        f"989 TFLOP/s), peak memory {tr['peak_gb']:.2f} GB; attention "
        f"launches {json.dumps(tr['launches'])}, plain runs 0; 2 layers "
        f"(cell A's weights, the reference's batch) {BF16_TWIN_STEPS} "
        f"steps: bf16 {tw['bf16']}, the f32 twin {tw['f32']}, the f32 twin "
        f"with bf16 storage {tw['f32_bf16_storage']}: bf16 compute "
        f"(bf16 - storage twin; step 0 bf16 - f32) "
        f"{max(tw['compute_diff']):.4g} (limit {tw['limit']:.4g}: twice "
        f"the CPU reference's step-0 bf16 error {tw['cpu_gap']:.4g}), bf16 "
        f"storage (storage twin - f32) {tw['storage_diff']}, bf16 - f32 "
        f"{tw['f32_diff']} (the reduced config's bf16-f32 gap on the CPU "
        f"{tw['reduced_gap']:.4g}); bf16 backward at (8, 128, "
        f"32/16, 128) window 1024 == plain (max abs err "
        f"{backward['err']:.3g}): {backward['ms']:.4f} ms on the card, "
        f"plain {backward['plain_ms']:.4f} ms, SDPA "
        + ("none" if backward["library_ms"] is None
           else f"{backward['library_ms']:.4f} ms")
        + f", bound {backward['bound'][0]:.4f} ms ({backward['bound'][1]}); "
        f"phase {wall:.1f} s ({serve_s:.1f} s to the end of serving)")
    return {"cells": cells, "serving": serving, "training": training,
            "backward": backward, "wall_s": wall}


def bf16_kernel_launches(kernels: list, bf16: dict) -> None:
    """Phase 24's launches on the attention rows of the kernels line: the
    bf16 serving and training paths, each counted from 0, and of them the
    bf16 tensor-core instantiations'."""
    paths = {"gemma3_bf16_serving": bf16["serving"]["launches"],
             "gemma3_bf16_training": bf16["training"]["launches"]}
    variants = {"decode_attention": "decode_attention_tc",
                "flash_attention": "flash_attention_bf16",
                "flash_attention_backward": "flash_attention_backward_bf16"}
    for x in kernels:
        v = variants.get(x["name"])
        if v is None:
            continue
        for path, counts in paths.items():
            x["launches_by_path"][path] = counts[x["name"]]
            x["launches"] += counts[x["name"]]
        x["launches_bf16_tensor_cores"] = {
            path: counts[v] for path, counts in paths.items()}


def tensor_parallel_kernel_rows(tpp: dict) -> list:
    """The kernel options' entries of the kernels line: launches of phase
    22's worlds, times at qwen2-vl-7b's context-parallel block (the rows
    from S / 3) and of the merged decode."""
    ka, n = tpp["kernels"], tpp["launches"]
    src = "src/repro_torch/kernels/csrc/"
    block = CP_SEQ // CP_MESH[1]
    out = []
    for name, part, wrapper, source, replaces in (
            ("flash_attention_q_start", "flash", "flash_attention",
             src + "attention.cu", "src/repro/kernels/flash_attn.py:47"),
            ("flash_attention_backward_q_start", "backward",
             "flash_attention_backward", src + "attention_bwd.cu",
             "src/repro/models/attention.py:64")):
        rows = ka[part]["float32"]["blocks"]
        head = rows[block]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "wrapper": f"{wrapper}(q_start=...)",
            "launches": n[name],
            "max_abs_err": max(ka[part][d]["err"] for d in ka[part]),
            "ms": head["ms"], "call_ms": head["call_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound"][0],
            "bound_by": head["bound"][1], "library_ms": head["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention "
                       "with the block's causal mask"
                       + (" (autograd.grad)" if part == "backward" else ""),
            "shape": dict(QSTART_CASE, rows=block, q_start=block),
            "dtype": "float32",
            "blocks": {d: {a: {f: r[f] for f in ("ms", "plain_ms",
                                                 "library_ms")}
                           | {"bound_ms": r["bound"][0]}
                           for a, r in ka[part][d]["blocks"].items()}
                       | {"whole_without_q_start_ms": ka[part][d]["whole_ms"]}
                       for d in ka[part]}})
    d = ka["decode"]
    out.append({
        "name": "decode_attention_with_lse", "route": "cuda",
        "source": src + "attention.cu",
        "replaces": "src/repro/kernels/decode_attn.py:26",
        "kernel": "decode_partial_kernel* + decode_combine_kernel<true>",
        "launches": n["decode_attention_with_lse"],
        "max_abs_err": d["err"], "ms": d["ms"], "call_ms": d["call_ms"],
        "plain_ms": d["plain_ms"], "bound_ms": d["bound"][0],
        "bound_by": d["bound"][1], "library_ms": d["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "without_lse_ms": d["without_lse_ms"], "shape": d["shape"],
        "dtype": "float32"})
    return out


def backward_kernel_row(bwd: dict, training: dict, multi: dict,
                        ptxas: dict) -> dict:
    """The flash backward's entry of the kernels line: launches of the
    training paths (phase 18, and phase 21's ranks), times at its shape
    and the others of phase 17."""
    head = bwd["cases"][BWD_TRAINING]
    return {
        "name": "flash_attention_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:64",
        "note": "no Pallas counterpart: the reference differentiates its "
                "jnp _sdpa (models/attention.py:64-78) with XLA's autodiff",
        "kernel": "bwd_dq_f32<D> + bwd_dkdv_f32<D, KB> (f32), "
                  "bwd_dq_bf16<D, NWG> + bwd_dkdv_bf16<D, SPLIT> "
                  "(bf16, wgmma)",
        "launches": training["launches"]["flash_attention_backward"]
        + multi["attention"]["flash_attention_backward"],
        "launches_by_path": {
            "training": training["launches"]["flash_attention_backward"],
            "mesh_training": multi["attention"]["flash_attention_backward"]},
        "max_abs_err": bwd["err"], "lse_max_abs_err": bwd["lse_err"],
        "ms": head["ms"], "call_ms": head["call_ms"],
        "dq_ms": head["dq_ms"], "dkdv_ms": head["dkdv_ms"],
        "split_windows": head["split_windows"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound"][0], "bound_by": head["bound"][1],
        "library_ms": head["library_ms"],
        "library": "torch.autograd.grad through "
                   "torch.nn.functional.scaled_dot_product_attention",
        "shape": head["shape"], "dtype": head["dtype"],
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith("bwd_")},
        "large": {k: {f: v[f] for f in ("shape", "dtype", "ms", "call_ms",
                                        "dq_ms", "dkdv_ms",
                                        "split_windows", "plain_ms",
                                        "library_ms", "forward_ms",
                                        "forward_lse_ms", "err", "lse_err")}
                  | {"bound_ms": v["bound"][0], "bound_by": v["bound"][1]}
                  for k, v in bwd["cases"].items() if k != BWD_TRAINING}}


def online_kernel_rows(online: dict, fleet: dict, multi: dict,
                       scan_ptxas: dict) -> list:
    """The stateful scans' entries of the kernels line: launches of the
    paths that run them (phase 14's cells, phase 15's 64-replica fleet and
    overload pair, phase 21's fleets on a fleet axis, every rank's),
    times at the online path's shape (the handed-off epoch) and at the
    fleet's B = 64 group."""
    source = "src/repro_torch/kernels/csrc/engine_scan.cu"
    rows = {"conv_scan": ("conv_scan_state",
                          "src/repro/kernels/engine_scan.py:248",
                          "conv_scan_kernel with state pointers"),
            "ext_scan": ("ext_scan_state",
                         "src/repro/kernels/engine_scan.py:283",
                         "ext_scan_kernel<K> with state pointers")}
    out = []
    for name, (row, replaces, kernel) in rows.items():
        t = online["handoff"]["timing"][name]
        f = fleet["b64"]["timing"][name]
        by_path = {"online": online["launches"][name],
                   "fleet": fleet["fleet"]["launches"][name],
                   "overload": sum(fleet["overload"][m]["launches"][name]
                                   for m in ("admission", "none")),
                   "mesh_fleet": multi["scans"][name]}
        out.append({
            "name": row, "route": "cuda", "source": source,
            "replaces": replaces, "kernel": kernel,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(online["handoff"]["err"][name],
                               fleet["b64"]["err"][name]),
            "ms": t["ms"], "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": None,
            "shape_BSL": t["shape"], "ways": t["ways"],
            "ms_by": t["ms_by"] + " (the wrapper reads the row contract's "
                     "verdict back, so no CUDA graph holds it)",
            "fleet_B64": {"ms": f["ms"], "ms_by": f["ms_by"],
                          "call_ms": f["call_ms"], "plain_ms": f["plain_ms"],
                          "bound_ms": f["bound"][0],
                          "bound_by": f["bound"][1], "shape_BSL": f["shape"],
                          "ways": f["ways"], "state_row_bytes": f["row_bytes"],
                          "row_contract_ms": f["contract_ms"],
                          "split": fleet["b64"]["split"]},
            "ptxas": {n: v for n, v in scan_ptxas.items()
                      if n.startswith(name.split("_")[0])}})
    return out


def attention_kernel_rows(ak: dict, serving: dict, path: dict, subs: dict,
                          golden_err: float, ptxas: dict,
                          training: dict, multi: dict) -> list:
    """The attention kernels' entries of the kernels line: launches of the
    two serving paths (phase 12's qwen3-4b and phase 16's families) and of
    the training paths (phase 18's qwen3-4b, phase 21's golden cell on
    its meshes, every rank's), each counted from 0, times at
    phase 12's most frequent shape, every shape of phase 16's path, the
    soft-capped decode (phase 16) and the large shapes of phase 10."""
    src = "src/repro_torch/kernels/csrc/attention.cu"
    rows = {"decode_attention": ("src/repro/kernels/decode_attn.py:26",
                                 "decode_partial_kernel<T, GB, Cfg> (CUDA "
                                 "cores) or decode_partial_kernel_tc (bf16, "
                                 "mma.sync) + decode_combine_kernel"),
            "flash_attention": ("src/repro/kernels/flash_attn.py:47",
                                "flash_kernel_f32<D> (f32, CUDA cores), "
                                "flash_kernel_bf16<D> (bf16, "
                                "wgmma.mma_async)")}

    def timed(t):
        return ({f: t[f] for f in ("shape", "kwargs", "dtype", "launches",
                                   "ms", "call_ms", "plain_ms", "library_ms",
                                   "err") if f in t}
                | {"bound_ms": t["bound"][0], "bound_by": t["bound"][1]})
    out = []
    for name, (replaces, kernel) in rows.items():
        head = max(path[name], key=lambda t: t["launches"])
        large = {k: {f: v[f] for f in ("shape", "dtype", "ms", "call_ms",
                                       "plain_ms", "library_ms")}
                 | {"bound_ms": v["bound"][0], "bound_by": v["bound"][1]}
                 for k, v in ak["large"].items() if v["wrapper"] == name}
        by_path = {"qwen3_serving": serving["launches"][name],
                   "families_serving": subs["launches"][name],
                   "qwen3_training": training["launches"][name],
                   "mesh_training": multi["attention"][name]}
        row = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "kernel": kernel,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max([ak["err"][name]]
                               + [t["err"] for t in path[name]]
                               + [t["err"] for t in subs["path"][name]]),
            "golden_lm_max_abs_err": golden_err,
            "ms": head["ms"], "call_ms": head["call_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound"][0],
            "bound_by": head["bound"][1], "library_ms": head["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention",
            "shape": head["shape"], "dtype": head["dtype"],
            "families_path_shapes": [timed(t) for t in subs["path"][name]],
            "ptxas": {k: v for k, v in ptxas.items()
                      if k.startswith(name.split("_")[0])},
            "large": large}
        if name == "decode_attention":
            row["softcap_gemma2"] = {k: timed(v) for k, v in
                                     subs["softcap"].items()}
            row["max_abs_err"] = max([row["max_abs_err"]] + [
                v["err"] for v in subs["softcap"].values()])
        out.append(row)
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
    ``decode_partial_kernel<bf16, 2, 128, 32, 3, true>`` (the last its
    soft cap), ``ext_scan_kernel<4>``,
    ``conv_scan_kernel``)."""
    import re
    out, cur = {}, None
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"(flash_kernel_f32|flash_kernel_bf16|"
                          r"bwd_dq_bf16|bwd_dkdv_bf16|bwd_dq_f32|"
                          r"bwd_dkdv_f32|"
                          r"decode_partial_kernel_tc|decode_partial_kernel|"
                          r"decode_combine_kernel|conv_scan_kernel|"
                          r"ext_scan_kernel)"
                          r"(?:(I.*?)?E[vP]|(?=ENS))", m.group(1))
            if k is None:
                cur = None
                continue
            args = [("bf16" if a == "13__nv_bfloat16" else
                     "float" if a == "If" else
                     {"Lb0E": "false", "Lb1E": "true"}.get(a) or
                     a.strip("LiE"))
                    for a in re.findall(r"13__nv_bfloat16|If|Li\d+E|Lb[01]E",
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
    att_ptxas = ptxas_summary(env.build.build_log("attention")
                              + env.build.build_log("attention_bwd"))
    for what, summary in (("engine-scan", scan_ptxas),
                          ("attention", att_ptxas)):
        log(f"phase 1: {what} kernels (ptxas): " + "; ".join(
            f"{k}: {v['registers']} registers, {v['spill_stores']} B spill "
            f"stores, {v['spill_loads']} B spill loads"
            for k, v in summary.items()))
    spills = [k for k, v in att_ptxas.items() if k.startswith("bwd_")
              and (v["spill_stores"] or v["spill_loads"])]
    if spills or not any(k.startswith("bwd_") for k in att_ptxas):
        fail(f"the flash backward kernels spill ({spills}) or are missing "
             "from the ptxas report")

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
    online = phase_online(env, dev)
    fleet = phase_fleet(env, dev)
    subs = phase_substrates(env, dev)
    bwd = phase_flash_backward(env, dev)
    training = phase_training(env, dev)
    phase_clis(env, dev)
    phase_roofline(env, dev, serving, training)
    multi = phase_multi_device(env, dev, fleet)
    tpp = phase_tensor_parallel(env, dev)
    entry = phase_entry_scripts(env, dev)
    bf16 = phase_bf16(env, dev)

    if any(m in sys.modules for m in ("jax", "repro")):
        fail("the port imported jax or repro")
    source = "src/repro_torch/kernels/csrc/engine_scan.cu"
    replaces = {"conv_scan": "src/repro/kernels/engine_scan.py:97",
                "ext_scan": "src/repro/kernels/engine_scan.py:135"}
    kernels = []
    for name in ("conv_scan", "ext_scan"):
        t = k["timing"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces[name],
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
    kernels += online_kernel_rows(online, fleet, multi, scan_ptxas)
    kernels += pool_kernel_rows(pk, cells, paths)
    kernels += attention_kernel_rows(ak, serving, att_path, subs,
                                     golden_lm["err"], att_ptxas, training,
                                     multi)
    kernels.append(backward_kernel_row(
        bwd, training, multi,
        ptxas_summary(env.build.build_log("attention_bwd"))))
    kernels += tensor_parallel_kernel_rows(tpp)
    for x in kernels:
        if x["name"] in ENTRY_ROWS:
            c, ws = ENTRY_ROWS[x["name"]]
            x["launches_entry_scripts"] = sum(entry["launches"][c].get(w, 0)
                                              for w in ws)
    bf16_kernel_launches(kernels, bf16)
    log("phase 25: kernels " + ", ".join(
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
