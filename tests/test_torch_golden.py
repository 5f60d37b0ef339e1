"""Golden results of the reference (jnp backend) at full width, kept in
tests/data/torch_golden_stats.json, which the port's chip check
(``chip_smoke.py``) holds the CUDA kernels to:

  * ``cells``: integer Stats of three cells (120 000 requests, seed 0)
    from ``repro.core.cache_sim.run_batch``;
  * ``table3``: the best splits of ``repro.core.policy.table3`` for three
    systems x three apps at 120 000 requests.

This test keeps the cells current (the Table-3 sweep takes about a
minute on one CPU, so only the regeneration recomputes it) and runs the
port's plain path on the CPU for the smallest cell.

Regenerate the file with ``PYTHONPATH=src python tests/test_torch_golden.py``.
"""
import json
import sys
from pathlib import Path

import jax  # noqa: F401  (both packages in one process, data as numpy)
import pytest

torch = pytest.importorskip("torch")

from repro.core import cache_sim as j_cs  # noqa: E402
from repro.core import controller as j_ctl  # noqa: E402
from repro.core import policy as j_policy  # noqa: E402
from repro_torch.core import cache_sim as t_cs  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_golden_stats.json"
CELLS = [("cfd", "Morpheus-ALL", 32, 36),
         ("kmeans", "Morpheus-Basic", 24, 44),
         ("spmv", "BL", 68, 0)]
LENGTH, SEED = 120_000, 0
TABLE3 = {"systems": ["IBL", "Morpheus-Basic", "Morpheus-ALL"],
          "apps": ["cfd", "kmeans", "spmv"], "length": LENGTH}


def reference_cells() -> list:
    pts = [j_cs.RunPoint(a, s, nc, nk, LENGTH, SEED, "jnp")
           for a, s, nc, nk in CELLS]
    return [{"app": p.app, "system": p.system, "n_compute": p.n_compute,
             "n_cache": p.n_cache, "length": LENGTH, "seed": SEED,
             "stats": {f: int(getattr(r.stats, f))
                       for f in j_ctl._INT_FIELDS}}
            for p, r in zip(pts, j_cs.run_batch(pts))]


def reference_table3() -> dict:
    tab = j_policy.table3(TABLE3["systems"], TABLE3["apps"],
                          length=LENGTH, backend="jnp")
    return {**TABLE3, "best_splits": {
        s: {a: [m.n_compute, m.n_cache] for a, m in row.items()}
        for s, row in tab.items()}}


def test_golden_file_is_current():
    golden = json.loads(GOLDEN.read_text())
    assert golden["cells"] == reference_cells()
    assert {k: golden["table3"][k] for k in TABLE3} == TABLE3


def test_port_plain_path_matches_golden_smallest_cell():
    cell = next(c for c in json.loads(GOLDEN.read_text())["cells"]
                if c["system"] == "BL")
    r = t_cs.run_batch([t_cs.RunPoint(cell["app"], cell["system"],
                                      cell["n_compute"], cell["n_cache"],
                                      cell["length"], cell["seed"])],
                       device="cpu")[0]
    assert {f: int(getattr(r.stats, f)) for f in cell["stats"]} == \
        cell["stats"]


if __name__ == "__main__":
    GOLDEN.parent.mkdir(exist_ok=True)
    GOLDEN.write_text(json.dumps({
        "source": "repro.core.cache_sim.run_batch and repro.core.policy."
                  "table3, backend jnp", "cells": reference_cells(),
        "table3": reference_table3()}, indent=1) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
