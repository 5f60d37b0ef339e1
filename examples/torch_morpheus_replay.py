"""Paper replay on the PyTorch port — one workload through the evaluated
systems (Fig. 12 row), the twin of ``examples/morpheus_replay.py``.

Runs a single memory-bound app through BL / IBL / IBL-4x-LLC /
Morpheus-Basic / Morpheus-ALL with the offline mode split
(``policy.best_split`` over the port's engine: on the card both scan
kernels of ``kernels/engine_scan.py``), and prints the normalized
execution-time row plus the predictor ablation (Fig. 13 row).  Every
split is searched anew: nothing is read from or written to a policy
cache.

  PYTHONPATH=src python examples/torch_morpheus_replay.py --app kmeans
  PYTHONPATH=src python examples/torch_morpheus_replay.py --device cpu

``run(app, length, device)`` returns what the script prints as a dict,
with each run's integer Stats.
"""
from __future__ import annotations

import argparse
from dataclasses import replace

from repro_torch.core import cache_sim as cs
from repro_torch.core import traces as tr
from repro_torch.core.controller import _INT_FIELDS, Predictor
from repro_torch.core.policy import best_split

SYSTEMS = ("BL", "IBL", "IBL-4x-LLC", "Morpheus-Basic", "Morpheus-ALL")
PREDICTORS = (Predictor.BLOOM, Predictor.NONE, Predictor.PERFECT)


def _row(r: cs.RunResult, base: cs.RunResult) -> dict:
    return {"n_compute": int(r.n_compute), "n_cache": int(r.n_cache),
            "norm_time": r.exec_time_s / base.exec_time_s,
            "hit_rate": float(r.llc_hit_rate), "mpki": float(r.mpki),
            "stats": {f: int(getattr(r.stats, f)) for f in _INT_FIELDS}}


def run(app: str = "kmeans", length: int = 30_000, device=None) -> dict:
    """The replay of ``app``: ``rows`` (system -> split, normalized time,
    hit rate, MPKI and integer Stats) and ``ablation`` (predictor -> the
    same at Morpheus-Basic's split), with ``_MB_<pred>`` systems
    registered in ``cache_sim.SYSTEMS`` as the reference script does."""
    base = cs.run(app, "BL", n_compute=cs.TOTAL_CORES, length=length,
                  device=device)
    rows = {}
    for system in SYSTEMS:
        if system == "BL":
            r = base
        else:
            split = best_split(app, system, length=length, device=device)
            r = cs.run(app, system, n_compute=split.n_compute,
                       n_cache=split.n_cache, length=length, device=device)
        rows[system] = _row(r, base)
    split = best_split(app, "Morpheus-Basic", length=length, device=device)
    ablation = {}
    for pred in PREDICTORS:
        name = f"_MB_{pred.value}"
        if name not in cs.SYSTEMS:
            cs.SYSTEMS[name] = replace(cs.SYSTEMS["Morpheus-Basic"],
                                       name=name, predictor=pred)
        r = cs.run(app, name, n_compute=split.n_compute,
                   n_cache=split.n_cache, length=length, device=device)
        ablation[pred.value] = _row(r, base)
    return {"app": app, "length": length,
            "memory_bound": bool(tr.WORKLOADS[app].memory_bound),
            "rows": rows, "ablation": ablation}


def lines(out: dict) -> list:
    """The reference script's printed lines of ``run``'s result."""
    kind = "memory" if out["memory_bound"] else "compute"
    text = [f"app = {out['app']} ({kind}-bound)", "",
            f"{'system':22s} {'cores':>11s} {'norm time':>9s} "
            f"{'hit rate':>8s} {'MPKI':>7s}"]
    for system, r in out["rows"].items():
        text.append(f"{system:22s} {r['n_compute']:3d}c+{r['n_cache']:3d}$ "
                    f"{r['norm_time']:9.3f} {r['hit_rate']:8.2f} "
                    f"{r['mpki']:7.1f}")
    text += ["", "predictor ablation (Morpheus-Basic split):"]
    for pred, r in out["ablation"].items():
        text.append(f"  {pred:10s} norm time {r['norm_time']:.3f}")
    return text


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="kmeans", choices=sorted(tr.WORKLOADS))
    ap.add_argument("--length", type=int, default=30_000)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions")
    args = ap.parse_args(argv)
    print("\n".join(lines(run(args.app, args.length, args.device))))


if __name__ == "__main__":
    main()
