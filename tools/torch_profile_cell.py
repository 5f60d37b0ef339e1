"""Hillclimb profiler on the PyTorch port: count one (arch x shape) cell
and rank its ops by counted bytes / FLOPs — the dry-run equivalent of a
memory profile; the twin of ``tools/profile_cell.py``.

  PYTHONPATH=src python tools/torch_profile_cell.py <arch> <shape> [pod2] [top_n]

counts the cell per chip on the (16, 16) pod, or with ``pod2`` on the
(2, 16, 16) pods, on ``meta`` in a fresh process holding a fake process
group of 256 or 512 ranks (``launch.dryrun.lower_cell``: the model placed
by tensor parallelism, the step counted by ``roofline.op_cost.analyze``),
and ranks the aten ops and kernel charges (``Cost.by_name``).

It also profiles the set-parallel cache-sim engine (the dispatch
``cache_sim.run_batch`` makes):

  PYTHONPATH=src python tools/torch_profile_cell.py engine <app>[:<system>[:n_compute[:n_cache]]] [top_n] [--device cpu]

which counts one ``engine._run_packed`` dispatch of the cell's 40 000
requests and ranks its ops the same way; on the card it adds the two
scan kernels' device ms from ``torch.profiler``.  ``--device cpu`` runs
the plain versions (the reference's ``jnp`` / ``pallas`` choice).

``profile_cell(...)`` and ``profile_engine(...)`` return what the script
prints as a dict.
"""
import json
import sys
import time

from repro_torch.core import cache_sim as cs
from repro_torch.core import engine as E
from repro_torch.launch import dryrun as D
from repro_torch.roofline import op_cost

KEEP = ("hlo_flops_per_chip", "hlo_bytes_per_chip",
        "collective_bytes_per_chip", "t_compute_s", "t_memory_s",
        "t_collective_s", "dominant", "roofline_fraction",
        "useful_flops_ratio", "compile_s")
SCAN_KERNELS = ("conv_scan_kernel", "ext_scan_kernel")
WINDOWS = 10      # profiled calls tried: a short window can lose its kernels


def rank_ops(cost: op_cost.Cost, top: int = 25) -> list:
    """[(name, bytes, FLOPs, calls)] of ``cost.by_name``, by bytes."""
    rows = [(k, float(v[2]), float(v[1]), int(v[0]))
            for k, v in cost.by_name.items()]
    return sorted(rows, key=lambda r: -r[1])[:top]


def ops_text(rows: list) -> list:
    out = [f"\n{'op':34s} {'GiB':>10s} {'GFLOP':>10s} {'count':>8s}"]
    for name, b, f, n in rows:
        out.append(f"{name[:34]:34s} {b / 2**30:10.3f} {f / 1e9:10.3f} "
                   f"{n:8d}")
    return out


def profile_cell(arch: str, shape: str, pod2: bool = False,
                 top: int = 25) -> dict:
    rep, cost = D.lower_cell(arch, shape, multi_pod=pod2, with_cost=True)
    return {"report": {k: rep.get(k) for k in KEEP},
            "flops": float(cost.flops), "bytes": float(cost.bytes),
            "ops": rank_ops(cost, top)}


def scan_device_ms(fn) -> dict:
    """Each scan kernel's device ms in a profiled call of ``fn``: the
    first of up to ``WINDOWS`` calls whose profile holds both kernels
    (``torch.profiler`` drops a short window's kernels at times), with
    its index as ``window``; zeros if none does."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for w in range(WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = dict.fromkeys(SCAN_KERNELS, 0.0)
        for e in prof.key_averages():
            us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
            for k in SCAN_KERNELS:
                if k in e.key:
                    out[k] += us / 1e3
        if all(out.values()):
            return dict(out, window=w)
    return dict(out, window=None)


def profile_engine(cell: str, top: int = 25, device=None) -> dict:
    """Count one ``_run_packed`` dispatch of ``cell`` (app[:system[:nc[:nk]]],
    40 000 requests) and rank its ops; on the card, each scan kernel's
    device ms in a profiled call."""
    dev = E.resolve_device(device)
    parts = cell.split(":")
    app = parts[0]
    system = parts[1] if len(parts) > 1 else "Morpheus-ALL"
    n_compute = int(parts[2]) if len(parts) > 2 else 32
    n_cache = int(parts[3]) if len(parts) > 3 else 36
    pt = cs.RunPoint(app, system, n_compute, n_cache, 40_000)
    cfg, trace, n_compute, n_cache, _ = cs._prepare(pt)
    packed = E.to_device(E.pack(cfg, [trace]), dev)
    run = lambda: E._run_packed(cfg, packed)         # noqa: E731
    run()                                            # warm
    t0 = time.perf_counter()
    cost = op_cost.analyze(run)
    out = {"cell": f"{app}:{system}:{n_compute}:{n_cache}",
           "device": str(dev),
           "conv_layout": list(packed.conv_tag.shape),
           "ext_layout": list(packed.ext_tag.shape),
           "flops": float(cost.flops), "bytes": float(cost.bytes),
           "count_s": time.perf_counter() - t0, "ops": rank_ops(cost, top)}
    if dev.type == "cuda":
        out["scan_device_ms"] = scan_device_ms(run)
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    arch, shape = argv[0], argv[1]
    top = int(argv[-1]) if argv[-1].isdigit() else 25
    if arch == "engine":
        out = profile_engine(shape, top, device)
        print(f"engine device: {out['device']}")
        print(json.dumps({k: out[k] for k in
                          ("cell", "conv_layout", "ext_layout", "flops",
                           "bytes")}, indent=1))
        print("\n".join(ops_text(out["ops"])))
        if "scan_device_ms" in out:
            ms = out["scan_device_ms"]
            print("\nscan kernels, device ms (torch.profiler): " + ", ".join(
                f"{k} {ms[k]:.4f}" for k in SCAN_KERNELS)
                + f" (window {ms['window']})")
        return
    out = profile_cell(arch, shape, pod2="pod2" in argv[2:], top=top)
    print(json.dumps(out["report"], indent=1))
    print("\n".join(ops_text(out["ops"])))


if __name__ == "__main__":
    main()
