"""Golden results of the reference's online runtime (``backend="jnp"``),
kept in tests/data/torch_golden_online.json, which the port's chip check
(``chip_smoke.py`` phase 14) holds the card to.

The cells are those of the reference's figure scripts at the ``full``
profile, all Morpheus-ALL on the 4-rung ladder ``LADDER_GRID``
(``benchmarks/fig_online.py:50``, ``benchmarks/fig_serving.py:41``):

  * ``stationary``: ``cfd``, 240 000 requests, epochs of 3 000, the
    default ``GovernorConfig`` (80 epochs);
  * ``phased``: ``("kmeans", "lib")``, 320 000 requests, epochs of 3 000;
  * ``tenants``: ``bursty_workload("cfd,kmeans",
    "mmpp:4e5,6e6,2e-3,6e-4", length=240_000, n_cores=32, seed=0)``,
    ``target_epoch`` 3 000, ``SERVING_GCFG``;
  * ``fixed``: the stationary cell pinned at the split (48, 20).

Each cell keeps its parameters, the candidate ladder, the decision
sequence (epoch, trigger, from_split, to_split, flush_writebacks), the
split of every epoch, the run's integer and float Stats, and for the
tenants cell the per-tenant integer Stats.  This test checks the file's
header and cell parameters against the definitions here, and replays
the smallest cell (``fixed``) through the port's plain path on the CPU.

Regenerate the file with
``PYTHONPATH=src python tests/test_torch_golden_online.py`` (about a
minute on one CPU).
"""
import json
import sys
from pathlib import Path

import jax  # noqa: F401  (both packages in one process, data as numpy)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import controller as j_ctl  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_golden_online.json"
SOURCE = ("repro.runtime.governor.simulate_online, backend jnp, the "
          "fig_online / fig_serving full-profile cells")
SYSTEM = "Morpheus-ALL"
LADDER_GRID = [18, 32, 48, 68]
MMPP = "mmpp:4e5,6e6,2e-3,6e-4"
CELLS = [
    {"name": "stationary", "phases": ["cfd"], "length": 240_000,
     "epoch_len": 3_000, "gcfg": "default", "fixed_split": None},
    {"name": "phased", "phases": ["kmeans", "lib"], "length": 320_000,
     "epoch_len": 3_000, "gcfg": "default", "fixed_split": None},
    {"name": "tenants", "mix": "cfd,kmeans", "arrival": MMPP,
     "length": 240_000, "n_cores": 32, "seed": 0, "target_epoch": 3_000,
     "gcfg": "serving", "fixed_split": None},
    {"name": "fixed", "phases": ["cfd"], "length": 240_000,
     "epoch_len": 3_000, "gcfg": "default", "fixed_split": [48, 20]},
]
FLOAT_RTOL = 1e-3


def run_cell(governor, bursty_workload, cell: dict, **device):
    """(result, candidates) of one cell through ``governor.simulate_online``
    of either package (``device`` is ``backend=`` or ``device=``)."""
    gcfg = governor.SERVING_GCFG if cell["gcfg"] == "serving" \
        else governor.GovernorConfig()
    fixed = tuple(cell["fixed_split"]) if cell["fixed_split"] else None
    if "mix" in cell:
        wl = bursty_workload(cell["mix"], cell["arrival"],
                             length=cell["length"], n_cores=cell["n_cores"],
                             seed=cell["seed"])
        cands = governor.candidates_for(wl.primary_app, SYSTEM,
                                        grid=LADDER_GRID,
                                        length=cell["length"])
        return governor.simulate_online(
            wl, SYSTEM, target_epoch=cell["target_epoch"], candidates=cands,
            gcfg=gcfg, fixed_split=fixed, **device), cands
    phases = cell["phases"][0] if len(cell["phases"]) == 1 \
        else tuple(cell["phases"])
    primary = next((a for a in cell["phases"]
                    if governor.tr.WORKLOADS[a].memory_bound),
                   cell["phases"][0]) if len(cell["phases"]) > 1 \
        else cell["phases"][0]
    cands = governor.candidates_for(primary, SYSTEM, grid=LADDER_GRID,
                                    length=cell["length"])
    return governor.simulate_online(
        phases, SYSTEM, length=cell["length"], epoch_len=cell["epoch_len"],
        candidates=cands, gcfg=gcfg, fixed_split=fixed, **device), cands


def summarize(result, cands) -> dict:
    """The golden record of one run (what the card must reproduce)."""
    out = {"candidates": [list(c) for c in cands],
           "epochs": len(result.records),
           "switches": int(result.switches),
           "decisions": [[d.epoch, d.trigger, list(d.from_split),
                          list(d.to_split), int(d.flush_writebacks)]
                         for d in result.decisions],
           "splits": [[r.n_compute, r.n_cache] for r in result.records],
           "int_stats": {f: int(np.asarray(getattr(result.stats, f)))
                         for f in j_ctl._INT_FIELDS},
           "float_stats": {f: float(np.asarray(getattr(result.stats, f)))
                           for f in result.stats._fields
                           if f not in j_ctl._INT_FIELDS}}
    if result.tenant_stats:
        out["tenant_int_stats"] = {
            name: {f: int(np.asarray(getattr(s, f)))
                   for f in j_ctl._INT_FIELDS}
            for name, s in result.tenant_stats.items()}
    return out


def reference_cells() -> list:
    from repro.runtime import governor
    from repro.workloads.serving import bursty_workload
    return [{**cell, **summarize(*run_cell(governor, bursty_workload, cell,
                                           backend="jnp"))}
            for cell in CELLS]


def test_golden_online_file_header():
    golden = json.loads(GOLDEN.read_text())
    assert golden["source"] == SOURCE
    assert (golden["system"], golden["ladder_grid"]) == (SYSTEM, LADDER_GRID)
    assert [{k: c[k] for k in cell} for c, cell in
            zip(golden["cells"], CELLS)] == CELLS
    for c in golden["cells"]:
        assert c["epochs"] == len(c["splits"]) > 0
        assert c["switches"] >= sum(a != b for a, b in
                                    zip(c["splits"], c["splits"][1:]))
        if "tenant_int_stats" in c:      # per-tenant sums == global
            for f, v in c["int_stats"].items():
                assert sum(t[f] for t in c["tenant_int_stats"].values()) \
                    == v, f


def test_port_plain_path_matches_golden_smallest_cell():
    from repro_torch.runtime import governor as t_gov
    from repro_torch.workloads.serving import bursty_workload as t_bursty
    cell = next(c for c in json.loads(GOLDEN.read_text())["cells"]
                if c["name"] == "fixed")
    got = summarize(*run_cell(t_gov, t_bursty, cell, device="cpu"))
    for key in ("candidates", "epochs", "switches", "decisions", "splits",
                "int_stats"):
        assert got[key] == cell[key], key
    for f, want in cell["float_stats"].items():
        assert abs(got["float_stats"][f] - want) <= \
            FLOAT_RTOL * max(abs(want), 1.0), f


if __name__ == "__main__":
    GOLDEN.parent.mkdir(exist_ok=True)
    GOLDEN.write_text(json.dumps({
        "source": SOURCE, "system": SYSTEM, "ladder_grid": LADDER_GRID,
        "cells": reference_cells()}, indent=1) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
