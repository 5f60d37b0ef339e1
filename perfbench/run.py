#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the CUDA card(s) of this
machine, and print its result as the last line of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics and the device's
breakdown.  Both decide ``correct`` by the comparison with the plain
reference (``pbcore/check.py``) and print the numbers compared, with
their limits, as the last lines of standard error.  The program's kernel
builds stay in the checkout (``build/``), so only a checkout's first run
of a cell compiles.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path[:0] = [str(HERE), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from pbcore import cell
    spec = cell.load(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < spec.chips:
        print(f"no result: {spec.name} needs {spec.chips} CUDA device(s), "
              f"this machine has {have}", file=sys.stderr)
        return 3
    tf32 = bool(spec.config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    ctx = cell.Ctx(spec, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START)
    rec = cell.run(ctx)
    found = cell.jax_modules()
    if found:
        print(f"no result: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    out = cell.result(ctx, rec)
    for name, c in out["checks"].items():
        op = ">=" if c.get("at_least") else "<="
        print(f"check {name}: {c['value']!r} (limit {op} {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
