"""Quickstart on the PyTorch port — the three layers of the framework, the
twin of ``examples/quickstart.py``.

  1. the Morpheus cache core: route -> predict -> lookup on a tiny pool
     (on the card the pool kernels ``lookup_fill``, ``bloom_query`` and
     ``bloom_record``),
  2. a model from the assigned-architecture zoo (reduced config) doing one
     forward / one AdamW train step (the flash forward and backward),
  3. the trace-driven paper simulator comparing BL vs Morpheus-ALL (both
     engine scans).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

``run(...)`` returns what the script prints as a dict.  The weights and
tokens are drawn from ``torch.Generator``s (seeds 0 and 1); ``params`` (the
reference's tree as numpy arrays, ``models.weights.params_from_numpy``)
and ``tokens`` replace them.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import cache_sim as cs
from repro_torch.core.controller import _INT_FIELDS
from repro_torch.core.engine import resolve_device
from repro_torch.models import build_model
from repro_torch.models.weights import params_to_numpy
from repro_torch.optim import AdamW
from repro_torch.pytree import flatten
from repro_torch.serving import MorpheusPagePool, PoolConfig
from repro_torch.train import init_state, make_train_step

POOL = dict(conv_sets=32, ext_sets_per_chip=16, num_cache_chips=2, ways=4)
KEYS = np.arange(100, 164, dtype=np.uint32)
ARCH, TOKENS_SHAPE, LR = "qwen3-4b", (2, 32), 1e-3
SIM = (("BL", 68, 0), ("Morpheus-ALL", 47, 21))
SIM_LENGTH = 20_000
RULE = "=" * 64


def pool_part(device=None) -> dict:
    """A cold and a warm pass of 64 keys through a 2-chip pool: its
    ``PoolStats``."""
    pool = MorpheusPagePool(PoolConfig(**POOL), device=device)
    pool.lookup_batch(KEYS)          # cold pass: misses, tags installed
    pool.lookup_batch(KEYS)          # warm pass: hits in both tiers
    return {k: float(v) if isinstance(v, (float, np.floating)) else int(v)
            for k, v in pool.stats._asdict().items()}


def model_part(device=None, params=None, tokens=None) -> dict:
    """Reduced qwen3-4b: one forward and one AdamW step (learning rate
    1e-3) on ``tokens`` as their own targets; the loss is the step's,
    before its update."""
    dev = resolve_device(device)
    cfg = configs.get(ARCH).reduced()
    model = build_model(cfg, device=dev)
    if tokens is None:
        g = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, TOKENS_SHAPE, generator=g,
                               dtype=torch.int32)
    tokens = torch.as_tensor(np.array(tokens)).to(dev)
    opt = AdamW(learning_rate=LR)
    state = init_state(model, opt, params if params is not None else
                       torch.Generator(device=dev).manual_seed(0))
    n_params = sum(int(np.prod(a.shape))
                   for _, a in flatten(params_to_numpy(model)))
    logits = model({"tokens": tokens})
    step = make_train_step(model, opt)
    state, metrics = step(state, {"tokens": tokens, "targets": tokens})
    return {"name": cfg.name, "n_params": n_params,
            "logits_shape": tuple(logits.shape),
            "finite": bool(torch.isfinite(logits).all()),
            "loss": float(metrics["loss"])}


def sim_part(device=None) -> dict:
    """kmeans on BL (68 compute cores) and Morpheus-ALL (47 + 21)."""
    out = {}
    for system, nc, nk in SIM:
        r = cs.run("kmeans", system, n_compute=nc, n_cache=nk,
                   length=SIM_LENGTH, device=device)
        out[system] = {"exec_time_s": r.exec_time_s,
                       "hit_rate": float(r.llc_hit_rate),
                       "mpki": float(r.mpki),
                       "stats": {f: int(getattr(r.stats, f))
                                 for f in _INT_FIELDS}}
    return out


def run(device=None, params=None, tokens=None) -> dict:
    return {"pool": pool_part(device),
            "model": model_part(device, params, tokens),
            "sim": sim_part(device)}


def lines(out: dict) -> list:
    """The reference script's printed lines of ``run``'s result."""
    s, m = out["pool"], out["model"]
    bl, mo = out["sim"]["BL"], out["sim"]["Morpheus-ALL"]
    return [
        RULE, "1) Morpheus page pool: conventional tier + extended tier + "
        "Bloom", RULE,
        f"  conv hits/misses:    {s['conv_hits']}/{s['conv_misses']}",
        f"  ext  hits:           {s['ext_hits']} (remote chips over ICI)",
        f"  predicted misses:    {s['ext_pred_miss']} (Bloom saved a round "
        "trip)",
        f"  false positives:     {s['ext_false_pos']} (correct, just "
        "slower)",
        "", RULE, "2) one assigned arch, reduced config: forward + train "
        "step", RULE,
        f"  {m['name']}: {m['n_params'] / 1e6:.2f}M params",
        f"  forward: logits {m['logits_shape']}, finite={m['finite']}",
        f"  train step: loss {m['loss']:.4f}",
        "", RULE, "3) paper simulator: kmeans on BL vs Morpheus-ALL", RULE,
        f"  BL           exec {bl['exec_time_s'] * 1e6:8.1f} us  "
        f"hit-rate {bl['hit_rate']:.2f}  MPKI {bl['mpki']:.1f}",
        f"  Morpheus-ALL exec {mo['exec_time_s'] * 1e6:8.1f} us  "
        f"hit-rate {mo['hit_rate']:.2f}  MPKI {mo['mpki']:.1f}",
        f"  speedup: {bl['exec_time_s'] / mo['exec_time_s']:.2f}x "
        "(paper: +39% avg across 14 apps)"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions")
    args = ap.parse_args(argv)
    print("\n".join(lines(run(args.device))))


if __name__ == "__main__":
    main()
