"""One-device dry run, after ``repro.launch.dryrun``: count one (arch x
shape) cell on one H100 without allocating anything, and set the count
against the card's roofline.

The reference lowers and compiles each cell for its production mesh
(256 or 512 devices) and reads XLA's HLO.  The port builds the model,
its inputs and caches on ``meta`` (``launch.specs``) and runs the step
under the op counter (``roofline.op_cost``), on one card:

  * train: ``train_step`` with AdamW at the reference's moment dtype
    (bf16 for a bf16 model), the backward and its recomputation
    included;
  * prefill: ``LM.prefill`` into the caches;
  * decode: ``LM.decode_step`` at ``cur_pos = seq_len - 1``, over a
    cache taken to hold every position up to it.

The report keeps the reference's keys; their values are the op
counter's, on one chip: ``hlo_flops_per_chip`` and
``hlo_bytes_per_chip`` are the counted FLOPs and bytes,
``xla_cost_analysis_flops`` the same FLOPs (there is no XLA count),
``lower_s`` the time to build the shapes and ``compile_s`` the count's
wall time.  ``device`` names where the count came from (``meta``: no
result was computed), ``fits`` sets ``bytes_per_chip`` against the
card's ``hbm_bytes``, and ``counted_on`` says which count differs from a
real run: an MoE layer's experts are charged a balanced router's rows
(``models.moe.balanced_counts``), the one count that depends on data a
``meta`` run does not have.

The production meshes (``multi_pod=True``, ``--multi-pod``,
``--both-meshes``), counted on a fake process group of 256 or 512
ranks, are not ported yet: ROADMAP A8.4b.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b

writes one JSON a cell under ``results/dryrun_torch/`` (the reference's
``results/dryrun/`` is never touched) and needs no card.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from .. import configs
from ..models import LM
from ..models import layers as L
from ..optim import AdamW
from ..pytree import parts
from ..roofline import (CHIP, collective_bytes, collective_op_counts,
                        cost_dict, memory_stats, model_flops, op_cost,
                        roofline_terms)
from ..train.train_step import init_state, make_train_step
from . import specs as S

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
MESH_ERROR = ("the production mesh (multi_pod, --multi-pod, --both-meshes) "
              "of 256 or 512 ranks is not ported yet (ROADMAP A8.4b)")
MESH_TAG = "h100x1"


def moment_dtype(cfg) -> torch.dtype:
    """AdamW's moment dtype in the reference's dry run: bf16 for a bf16
    model."""
    return (torch.bfloat16 if cfg.param_dtype == "bfloat16"
            else torch.float32)


def count_train(model, batch, opt=None, microbatches: int = 1
                ) -> op_cost.Cost:
    """The op counter's ``Cost`` of one ``train_step`` of ``model`` on
    ``batch`` (``opt`` by default AdamW at the reference's moment
    dtype), the backward included; the state's tensors and the batch are
    the arguments."""
    opt = opt or AdamW(moment_dtype=moment_dtype(model.cfg))
    state = init_state(model, opt)
    step = make_train_step(model, opt, microbatches=microbatches)
    tensors = parts(state.params) + parts(state.opt.mu) + parts(state.opt.nu)
    return op_cost.analyze(lambda _, b: step(state, b), tensors, batch)


def count_prefill(model, batch, caches) -> op_cost.Cost:
    """The ``Cost`` of ``model.prefill(batch, caches)``."""
    return op_cost.analyze(lambda _, b, c: model.prefill(b, c),
                           list(model.parameters()), batch, caches)


def count_decode(model, tokens, caches, cur_pos: int) -> op_cost.Cost:
    """The ``Cost`` of one ``model.decode_step`` at ``cur_pos``."""
    return op_cost.analyze(
        lambda _, t, c: model.decode_step(t, c, cur_pos),
        list(model.parameters()), tokens, caches)


def count_cell(cfg, shape, *, microbatches: int = 1, model=None
               ) -> op_cost.Cost:
    """The ``Cost`` of one step of ``cfg`` at ``shape`` on ``meta``."""
    model = model if model is not None else LM(cfg, device=S.META)
    batch = S.input_specs(cfg, shape)
    if shape.kind == "train":
        return count_train(model, batch, microbatches=microbatches)
    caches = S.abstract_caches(model, shape)
    if shape.kind == "prefill":
        return count_prefill(model, batch, caches)
    return count_decode(model, batch["tokens"], caches, shape.seq_len - 1)


def report(arch: str, shape_name: str, cost: op_cost.Cost, *,
           microbatches: int = 1, lower_s: float = 0.0) -> dict:
    """The reference's report keys over a ``meta`` count of one cell on
    one chip."""
    cfg = configs.get(arch)
    shape = configs.SHAPES[shape_name]
    dtype = L.dtype_of(cfg)
    flops, bytes_hbm = float(cost.flops), float(cost.bytes)
    coll_total, coll_by_kind = collective_bytes(cost)
    terms = roofline_terms(flops=flops, bytes_hbm=bytes_hbm,
                           bytes_collective=coll_total, chips=1,
                           dtype=dtype)
    mflops = model_flops(cfg, shape)
    mem = memory_stats(cost)
    per_chip = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    return {
        "arch": arch, "shape": shape_name, "mesh": "1", "chips": 1,
        "kind": shape.kind, "microbatches": microbatches, "ok": True,
        "device": "meta", "chip": "NVIDIA H100 SXM5 (datasheet)",
        "compute_dtype": str(dtype).replace("torch.", ""),
        "lower_s": round(lower_s, 2), "compile_s": round(cost.seconds, 2),
        "hlo_flops_per_chip": flops, "hlo_bytes_per_chip": bytes_hbm,
        "collective_bytes_per_chip": int(coll_total),
        "collective_by_kind": coll_by_kind,
        "collective_counts": collective_op_counts(cost),
        "xla_cost_analysis_flops": cost_dict(cost)["flops"],
        "model_flops_per_chip": mflops,
        "useful_flops_ratio": (mflops / flops) if flops else None,
        "memory": mem, "bytes_per_chip": per_chip,
        "hbm_bytes": CHIP.hbm_bytes, "fits": per_chip <= CHIP.hbm_bytes,
        "counted_on": ("meta: each MoE expert charged a balanced router's "
                       "rows (models.moe.balanced_counts)"
                       if cfg.num_experts else "meta"),
        **terms,
    }


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               microbatches: int = 1) -> dict:
    """Count one (arch x shape) cell on one H100 on ``meta``; return the
    report."""
    if multi_pod:
        raise NotImplementedError(f"dryrun: {MESH_ERROR}")
    cfg = configs.get(arch)
    shape = configs.SHAPES[shape_name]
    t0 = time.perf_counter()
    model = LM(cfg, device=S.META)
    lower_s = time.perf_counter() - t0
    cost = count_cell(cfg, shape, microbatches=microbatches, model=model)
    return report(arch, shape_name, cost, microbatches=microbatches,
                  lower_s=lower_s)


def run_cells(cells, *, multi_pod: bool, out_dir: Path):
    if multi_pod:
        raise NotImplementedError(f"dryrun: {MESH_ERROR}")
    out_dir.mkdir(parents=True, exist_ok=True)
    for arch, shape_name, skipped in cells:
        name = f"{arch}__{shape_name}__{MESH_TAG}.json"
        path = out_dir / name
        if path.exists():
            print(f"[skip existing] {name}")
            continue
        if skipped:
            path.write_text(json.dumps(
                {"arch": arch, "shape": shape_name, "ok": True,
                 "skipped": True,
                 "reason": "full-attention@500k (DESIGN.md)"}, indent=1))
            print(f"[documented skip] {name}")
            continue
        print(f"=== {arch} x {shape_name} ({MESH_TAG}) ===", flush=True)
        try:
            rep = lower_cell(arch, shape_name)
            print(f"  ok: count={rep['compile_s']}s dominant="
                  f"{rep['dominant']} frac={rep['roofline_fraction']:.3f} "
                  f"fits={rep['fits']}", flush=True)
        except Exception as e:  # record failures: they are bugs to fix
            rep = {"arch": arch, "shape": shape_name, "ok": False,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            print(f"  FAILED: {type(e).__name__}: {str(e)[:200]}", flush=True)
        path.write_text(json.dumps(rep, indent=1, default=str))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)
    if args.multi_pod or args.both_meshes:
        raise SystemExit(f"dryrun: {MESH_ERROR}")

    cells = configs.cells(include_skipped=True)
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    run_cells(cells, multi_pod=False, out_dir=Path(args.out))


if __name__ == "__main__":
    main()
