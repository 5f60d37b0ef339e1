"""End-to-end serving on the PyTorch port — batched requests through the
two-tier Morpheus page pool, the twin of ``examples/serve_morpheus.py``.

Serves batches of prompts on a reduced assigned-arch model: batch 1 cold
(every prefix page is a backing fetch), later batches warm (prefix pages
hit the Morpheus tiers).  Verifies the Morpheus tier is *transparent*:
generated tokens match a pool-less engine exactly.  On the card the
engine runs the flash and decode kernels and the pool's kernels.

``--split`` picks the mode split of the page pool: an integer pins the
cache-chip count (``runtime.demo_pool``); ``auto`` hands it to the
adaptive runtime governor (``runtime.ServingGovernor``), which watches
the pool's observed request mix between batches and prints its
per-epoch decisions.  ``--workload``/``--arrival`` schedule the rounds
from ``workloads.serving`` (``round_requests``, ``batch_mix``);
``--slo-ms`` sizes them by the closed-loop ``SLOBudgeter``.

  PYTHONPATH=src python examples/torch_serve_morpheus.py --device cpu
  PYTHONPATH=src python examples/torch_serve_morpheus.py --split auto \\
      --rounds 6
  PYTHONPATH=src python examples/torch_serve_morpheus.py --split auto \\
      --rounds 8 --workload tenantA,tenantB --arrival onoff:64,0.5,0.5
  PYTHONPATH=src python examples/torch_serve_morpheus.py --split auto \\
      --workload tenantA,tenantB --slo-ms 2.5

``run(cfg, ...)`` serves any config (the CLI builds ``configs.get(arch)
.reduced()``) and returns what the script prints as a dict, with every
``EngineReport`` and governor record.  The weights are drawn from a
``torch.Generator`` (seed 0) on the device; ``params`` (the reference's
tree as numpy arrays) replaces them.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs
from repro_torch.core.engine import resolve_device
from repro_torch.models import build_model, params_from_numpy
from repro_torch.runtime import (SERVING_GCFG, ServingGovernor, demo_pool,
                                 describe_tick)
from repro_torch.serving import Engine, Request
from repro_torch.workloads.serving import (SLOBudgeter, batch_mix,
                                           round_requests, slo_batches)


def make_requests(batch: int, prompt_len: int, max_new: int, *, offset=0):
    return [Request(rid=offset + i,
                    prompt=[(7 * j + 3) % 97 + 1 for j in range(prompt_len)],
                    max_new_tokens=max_new)
            for i in range(batch)]


def build(cfg, device=None, params=None):
    """The port's LM of ``cfg`` on ``device`` with weights from ``params``
    or from a generator seeded with 0."""
    dev = resolve_device(device)
    model = build_model(cfg, device=dev)
    if params is not None:
        params_from_numpy(model, params)
    else:
        model.init_weights(torch.Generator(device=dev).manual_seed(0))
    return model


def run(cfg, *, batch: int = 4, prompt_len: int = 32, max_new: int = 8,
        split: str = "static", rounds=None, workload=None, arrival=None,
        slo_ms=None, device=None, params=None,
        log=lambda line: None) -> dict:
    """Serve ``cfg`` as the reference script does, ``log`` receiving each
    printed line; returns the rounds (reports, wall s, tokens/s, arrival
    mixes, governor records), the pool stats and the transparency check."""
    model = build(cfg, device, params)
    log(f"serving {cfg.name} | batch {batch} | prompt {prompt_len} | "
        f"+{max_new} tokens\n")
    max_len = prompt_len + max_new + 8
    pool = governor = None
    if split not in ("static", "auto"):
        pool = demo_pool(int(split), device=model.device)
    eng = Engine(model, max_len=max_len, morpheus=True, pool=pool)
    if split == "auto":
        # conservative preset: bursty rounds / idle windows thrash the
        # default config's phase detector
        governor = ServingGovernor(eng.pool, gcfg=SERVING_GCFG)
        log(f"governor: candidates {governor.gov.candidates}, starting "
            f"at {eng.pool.cfg.num_cache_chips} cache chips")

    rounds = rounds or (6 if governor or slo_ms else 2)
    budgeter = batches = sched = None
    if slo_ms:
        budgeter = SLOBudgeter(slo_ms, max_batch=4 * batch,
                               initial_batch=batch)
        batches = slo_batches(workload or "demo", budgeter, prompt_len)
        log(f"slo budgeter: target {slo_ms:g} ms/round, budget "
            f"{budgeter.min_batch}..{budgeter.max_batch} reqs")
    elif workload or arrival:
        sched = round_requests(workload or "demo", arrival or f"det:{batch}",
                               rounds, batch, prompt_len)
    out = {"rounds": [], "ticks": []}
    rid = 0
    pool_last = eng.pool.stats
    for rnd in range(rounds):
        tag = "cold" if rnd == 0 else f"warm{rnd}"
        row = {"tag": tag}
        if sched is None and batches is None:
            reqs = make_requests(batch, prompt_len, max_new)
        else:
            arrivals = next(batches) if batches is not None else sched[rnd]
            if not arrivals:
                log(f"[{tag}] idle window (no arrivals)")
                if governor is not None:
                    rec = governor.tick()
                    out["ticks"].append(rec)
                    log("       " + describe_tick(rec))
                out["rounds"].append(row)
                continue
            mix = batch_mix(arrivals)
            row["mix"] = mix
            log(f"[{tag}] arrivals: "
                + "+".join(f"{k}:{v}" for k, v in mix.items()))
            reqs = [Request(rid=rid + i, prompt=toks, max_new_tokens=max_new)
                    for i, (_, toks) in enumerate(arrivals)]
            rid += len(reqs)
        t0 = time.time()
        rep = eng.run(reqs)
        dt = time.time() - t0
        row.update(report=dataclasses.asdict(rep), seconds=dt,
                   tokens_per_s=rep.generated / dt,
                   tokens=[r.out_tokens for r in reqs])
        log(f"[{tag}] generated {rep.generated} tokens in {dt:.2f}s "
            f"({row['tokens_per_s']:.1f} tok/s)")
        log(f"       prefix pages reused {rep.pages_reused}, "
            f"fetched from backing {rep.pages_fetched}")
        if budgeter is not None:
            d = eng.pool.stats - pool_last
            pool_last = eng.pool.stats
            ns_per = d.time_ns / d.lookups if d.lookups else 0.0
            budgeter.observe(ns_per, d.lookups, len(reqs))
            est = budgeter.ns_per_request or 0.0
            row["slo"] = (est * len(reqs) / 1e6, budgeter.next_budget())
            log(f"       slo: {row['slo'][0]:.3f} ms modeled "
                f"(target {slo_ms:g}) | next budget {row['slo'][1]}")
        if governor is not None:
            rec = governor.tick()
            out["ticks"].append(rec)
            log("       " + describe_tick(rec))
        out["rounds"].append(row)
    s = eng.pool.stats
    out["pool_stats"] = dict(s._asdict())
    log(f"\npool stats: conv hits {s.conv_hits} | ext hits {s.ext_hits} | "
        f"pred-miss {s.ext_pred_miss} | false-pos {s.ext_false_pos} | "
        f"backing {s.backing_fetches}")

    # --- transparency check: Morpheus must not change the output tokens
    ref = Engine(model, max_len=max_len, morpheus=False)
    r_on = make_requests(batch, prompt_len, max_new)
    r_off = make_requests(batch, prompt_len, max_new)
    Engine(model, max_len=max_len, morpheus=True).run(r_on)
    ref.run(r_off)
    match = all(a.out_tokens == b.out_tokens for a, b in zip(r_on, r_off))
    out["tokens_on"] = [r.out_tokens for r in r_on]
    out["tokens_off"] = [r.out_tokens for r in r_off]
    out["match"] = match
    log(f"tokens identical with/without Morpheus tier: {match}")
    assert match, "Morpheus tier changed the generated tokens!"
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b",
                    choices=sorted(configs.ALL_ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--split", default="static",
                    help="'auto' = adaptive governor; an integer pins the "
                         "cache-chip count; default keeps the engine's "
                         "static pool")
    ap.add_argument("--rounds", type=int, default=None,
                    help="number of serving rounds (default 2, or 6 with "
                         "--split auto)")
    ap.add_argument("--workload", default=None,
                    help="tenant prompt families, comma-joined "
                         "(e.g. 'tenantA,tenantB')")
    ap.add_argument("--arrival", default=None,
                    help="per-round arrival process: det:R | poisson:R | "
                         "mmpp:Ra,Rb,Ta,Tb | onoff:R,Ton,Toff")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="SLO-driven round sizing: closed-loop budgeter "
                         "targets this modeled ms/round instead of a "
                         "fixed round size")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions")
    args = ap.parse_args(argv)
    run(configs.get(args.arch).reduced(), batch=args.batch,
        prompt_len=args.prompt_len, max_new=args.max_new, split=args.split,
        rounds=args.rounds, workload=args.workload, arrival=args.arrival,
        slo_ms=args.slo_ms, device=args.device, log=print)


if __name__ == "__main__":
    main()
