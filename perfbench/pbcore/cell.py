"""A cell's files, found by the names in ``BENCHMARK.json``, and one run
of it turned into the result line.

  * the configuration: the file its ``configs`` entry names;
  * the traffic mix: ``mixes/<traffic>.json``;
  * the limits of the comparison: ``limits/<workload>.json``;
  * every metric, end-to-end or per layer: ``metrics/<name>.py``, or
    where there is none ``metrics/<stem>.py`` of the name's part before
    its first dot, so that ``prefill_ms.ttft`` and ``prefill_ms.tput``
    share a reader; its ``read(record)`` returns the number or None where
    it finds nothing to read (the metric is then left out of the line);
  * the driver of the mix's ``kind``: ``pbcore/<kind>.py``.

A new configuration, mix or metric is a new file and a new entry in
``BENCHMARK.json``; nothing here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Dict, List, NamedTuple

import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
JAX_NAMES = ("jax", "jaxlib", "flax", "repro")


class Cell(NamedTuple):
    name: str
    root: Path
    chips: int
    traffic: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


class Ctx(NamedTuple):
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix

    @property
    def limits(self) -> dict:
        return self.cell.limits


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    name, else every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it ``moves`` (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load(name: str, root: Path = ROOT) -> Cell:
    """Cell ``name`` of ``root/BENCHMARK.json``, with its files."""
    bench = _json(root / "BENCHMARK.json")
    here = root / HERE.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                         f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, root, w["chips"], w["traffic"],
                _json(root / conf["file"]),
                _json(here / "mixes" / f"{w['traffic']}.json"),
                _json(here / "limits" / f"{name}.json"), e2e, per)


def reader(metric: str, root: Path = ROOT):
    """``read`` of ``metrics/<metric>.py``, else of its stem's file."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = path.with_name(f"{metric.split('.')[0]}.py")
    mod_name = "pbmetric_" + re.sub(r"\W", "_", metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run(ctx: Ctx) -> dict:
    """One run of the cell: the record its kind's driver returns."""
    return importlib.import_module(f".{ctx.mix['kind']}", __package__
                                   ).run(ctx)


def jax_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(JAX_NAMES))


def result(ctx: Ctx, rec: dict) -> dict:
    """The result line: ``correct``, the counts, the cell's end-to-end
    (``--trace 0``) or per-layer (``--trace 1``) metrics, the device, the
    traced breakdown, and last the numbers compared with their limits."""
    from . import check
    from .trace import top
    metrics: Dict[str, dict] = {}
    for m in (ctx.cell.per_layer if ctx.trace else ctx.cell.end_to_end):
        v = reader(m["name"], ctx.cell.root)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                       else "cpu"),
              "count": ctx.cell.chips,
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": check.passed(rec["checks"]),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": device}
    tr = rec.get("trace")
    if ctx.trace and tr:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": top(tr["by_name"]),
                            "idle_gaps": top(tr["idle"])}
    out["checks"] = rec["checks"]
    return out
