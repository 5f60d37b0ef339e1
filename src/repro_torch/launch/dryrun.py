"""Dry runs, after ``repro.launch.dryrun``: count one (arch x shape) cell
on one H100, or per chip on a production mesh, without allocating
anything, and set the count against the card's roofline.

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

The production meshes (``lower_cell(multi_pod=False)``: (16, 16) over
("data", "model"), 256 chips; ``multi_pod=True``: (2, 16, 16) over
("pod", "data", "model"), 512 chips; ``--multi-pod``, ``--both-meshes``)
are counted per chip, as the reference's post-SPMD HLO is: a ``fake``
process group of 256 or 512 ranks (``torch.testing._internal.distributed
.fake_pg``; its collectives move nothing) in a fresh process, the
production ``DeviceMesh`` over it (``launch.mesh``), the model placed by
``distributed.tensor_parallel`` on ``meta`` (parameters by
``param_specs``, AdamW's moments by ``opt_state_specs`` with ZeRO-1,
the inputs by ``batch_spec``, the caches by ``cache_shardings``), and
the step counted on rank 0 by the op counter, which counts DTensor
programs per rank: the local ops at local shapes and the redistributions'
``_c10d_functional`` collectives by kind (``collective_by_kind``,
``collective_counts``).  ``bytes_per_chip`` and ``fits`` are the rank's
own shards and temporaries.  Rank 0 holds block 0 of every sharded
dimension: under context parallelism its causal block of rows sees the
fewest keys, so its attention count is the least of the ranks'.  The
files end ``__pod1`` / ``__pod2``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes

writes one JSON a cell under ``results/dryrun_torch/`` (the reference's
``results/dryrun/`` is never touched) and needs no card.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from .. import configs
from ..distributed import tensor_parallel as tp
from ..models import LM
from ..models import layers as L
from ..optim import AdamW
from ..pytree import parts
from ..roofline import (CHIP, collective_bytes, collective_op_counts,
                        cost_dict, memory_stats, model_flops, op_cost,
                        roofline_terms)
from ..train.train_step import init_state, make_train_step
from . import specs as S
from .mesh import make_production_mesh

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
MESH_TAG = "h100x1"


def mesh_name(multi_pod: Optional[bool]) -> str:
    """The report's ``mesh``: "1" on one chip, else the reference's."""
    return "1" if multi_pod is None else ("2x16x16" if multi_pod
                                           else "16x16")


def mesh_tag(multi_pod: Optional[bool]) -> str:
    """The file name's mesh tag."""
    return MESH_TAG if multi_pod is None else ("pod2" if multi_pod
                                               else "pod1")


def chips_of(multi_pod: Optional[bool]) -> int:
    return 1 if multi_pod is None else (512 if multi_pod else 256)


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
    """The ``Cost`` of ``model.prefill(batch, caches)`` (on a mesh, the
    step's logits left sharded, as the reference's jitted step leaves
    them)."""
    def run(_, b, c):
        with torch.no_grad(), model.mesh_context():
            return model._prefill(b, c)
    return op_cost.analyze(run, list(model.parameters()), batch, caches)


def count_decode(model, tokens, caches, cur_pos: int) -> op_cost.Cost:
    """The ``Cost`` of one ``model.decode_step`` at ``cur_pos`` (the
    logits left sharded on a mesh)."""
    def run(_, t, c):
        with torch.no_grad(), model.mesh_context():
            return model._decode_step(t, c, cur_pos)
    return op_cost.analyze(run, list(model.parameters()), tokens, caches)


def count_cell(cfg, shape, *, microbatches: int = 1, model=None
               ) -> op_cost.Cost:
    """The ``Cost`` of one step of ``cfg`` at ``shape`` on ``meta``."""
    model = model if model is not None else LM(cfg, device=S.META)
    batch = S.input_specs(cfg, shape)
    if shape.kind == "train":
        return count_train(model, batch, microbatches=microbatches)
    caches = S.abstract_caches(model, shape)   # placed on a mesh
    if model.mesh is not None and caches.enc_out is not None:
        caches.enc_out = tp.batch_input(caches.enc_out, model.mesh)
    if shape.kind == "prefill":
        return count_prefill(model, batch, caches)
    return count_decode(model, batch["tokens"], caches, shape.seq_len - 1)


def report(arch: str, shape_name: str, cost: op_cost.Cost, *,
           microbatches: int = 1, lower_s: float = 0.0,
           multi_pod: Optional[bool] = None) -> dict:
    """The reference's report keys over a ``meta`` count of one cell on
    one chip (``multi_pod`` None) or per chip on a production mesh."""
    cfg = configs.get(arch)
    shape = configs.SHAPES[shape_name]
    dtype = L.dtype_of(cfg)
    flops, bytes_hbm = float(cost.flops), float(cost.bytes)
    coll_total, coll_by_kind = collective_bytes(cost)
    terms = roofline_terms(flops=flops, bytes_hbm=bytes_hbm,
                           bytes_collective=coll_total, chips=1,
                           dtype=dtype)
    chips = chips_of(multi_pod)
    mflops = model_flops(cfg, shape) / chips
    mem = memory_stats(cost)
    per_chip = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
        "chips": chips,
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
        "counted_on": (("meta" if multi_pod is None else
                        f"meta, rank 0 of a fake group of {chips}")
                       + (": each MoE expert charged a balanced router's "
                          "rows (models.moe.balanced_counts)"
                          if cfg.num_experts else "")),
        **terms,
    }


def lower_cell(arch: str, shape_name: str, *,
               multi_pod: Optional[bool] = None,
               microbatches: int = 1, with_cost: bool = False):
    """Count one (arch x shape) cell on ``meta`` and return the report: on
    one H100 (``multi_pod`` None), or per chip on the (16, 16) pod
    (False) or the (2, 16, 16) pods (True), in a fresh process that holds
    a fake group of 256 or 512 ranks unless this process is already rank
    0 of one that size; with ``with_cost``, (report, its ``Cost``)."""
    args = (arch, shape_name, multi_pod, microbatches, with_cost)
    if multi_pod is None or in_fake_world_of(chips_of(multi_pod)):
        return _lower(*args)
    return in_fake_world(chips_of(multi_pod), _lower, *args)


def _lower(arch: str, shape_name: str, multi_pod: Optional[bool],
           microbatches: int, with_cost: bool = False):
    cfg = configs.get(arch)
    shape = configs.SHAPES[shape_name]
    t0 = time.perf_counter()
    model = LM(cfg, device=S.META)
    if multi_pod is not None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        tp.distribute_model(model, mesh, device=S.META)
    lower_s = time.perf_counter() - t0
    cost = count_cell(cfg, shape, microbatches=microbatches, model=model)
    rep = report(arch, shape_name, cost, microbatches=microbatches,
                 lower_s=lower_s, multi_pod=multi_pod)
    return (rep, cost) if with_cost else rep


# ------------------------------------------------ the fake process group

def in_fake_world_of(n_ranks: int) -> bool:
    """Whether this process is rank 0 of a ``fake`` group of ``n_ranks``."""
    return (dist.is_initialized() and dist.get_backend() == "fake"
            and dist.get_world_size() == n_ranks)


def _fake_main(n_ranks: int, fn, args):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    torch.set_num_threads(1)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        return fn(*args)
    finally:
        dist.destroy_process_group()


def in_fake_world(n_ranks: int, fn, *args):
    """``fn(*args)`` in a fresh process as rank 0 of a ``fake`` group of
    ``n_ranks`` (256 for the pod, 512 for two), which never meets this
    process's world; ``fn`` and its result must pickle."""
    with mp.get_context("spawn").Pool(1) as pool:
        return pool.apply(_fake_main, (n_ranks, fn, args))


def run_cells(cells, *, multi_pod: Optional[bool], out_dir: Path):
    """Count and write each cell (one process for all of them on a
    production mesh); a failed cell's report records its error."""
    if multi_pod is not None and not in_fake_world_of(chips_of(multi_pod)):
        return in_fake_world(chips_of(multi_pod), _run_cells, cells,
                             multi_pod, out_dir)
    return _run_cells(cells, multi_pod, out_dir)


def _run_cells(cells, multi_pod: Optional[bool], out_dir: Path):
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = mesh_tag(multi_pod)
    for arch, shape_name, skipped in cells:
        name = f"{arch}__{shape_name}__{tag}.json"
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
        print(f"=== {arch} x {shape_name} ({tag}) ===", flush=True)
        try:
            rep = lower_cell(arch, shape_name, multi_pod=multi_pod)
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

    cells = configs.cells(include_skipped=True)
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    meshes = ([False, True] if args.both_meshes
              else [True] if args.multi_pod else [None])
    for m in meshes:
        run_cells(cells, multi_pod=m, out_dir=Path(args.out))


if __name__ == "__main__":
    main()
