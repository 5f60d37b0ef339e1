"""Trace-corpus CLI on the PyTorch port: export / validate / inspect
``.npz`` LLC traces; the twin of ``tools/trace_corpus.py``.

  PYTHONPATH=src python tools/torch_trace_corpus.py export cfd out.npz \\
      --length 60000 --n-cores 32 [--ws-scale 0.125] [--seed 0]
  PYTHONPATH=src python tools/torch_trace_corpus.py export \\
      phased:kmeans+lib out.npz
  PYTHONPATH=src python tools/torch_trace_corpus.py validate out.npz
  PYTHONPATH=src python tools/torch_trace_corpus.py info out.npz

``export`` materializes any registered trace source (synthetic app,
phased list, or another corpus — ``src/repro_torch/workloads/sources.py``)
into the corpus format of ``src/repro_torch/workloads/corpus.py``, the
reference's format: a file either package writes, the other's tool reads
with the same output.  ``validate`` exits non-zero with the list of
problems if the file is malformed; ``info`` prints metadata plus
footprint/write-mix statistics.  The trace generators are host numpy:
no device is involved, so the tool takes no ``--device``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.workloads import corpus, sources        # noqa: E402


def export(source: str, out: str, *, length: int = 60_000, n_cores: int = 32,
           seed: int = 0, ws_scale: float = 1.0) -> dict:
    src = sources.make_source(source)
    addrs, writes, levels = src.generate(n_cores=n_cores, length=length,
                                         seed=seed, ws_scale=ws_scale)
    path = corpus.save_trace(out, addrs, writes, levels, name=src.name,
                             like=src.app, n_cores=n_cores, seed=seed,
                             ws_scale=ws_scale)
    return {"name": src.name, "length": length, "path": str(path)}


def validate(path: str) -> dict:
    return {"path": path, "problems": list(corpus.validate_trace(path))}


def info(path: str) -> dict:
    return corpus.trace_info(path)


def cmd_export(args) -> int:
    r = export(args.source, args.out, length=args.length,
               n_cores=args.n_cores, seed=args.seed, ws_scale=args.ws_scale)
    print(f"exported {r['name']} ({r['length']} accesses) -> {r['path']}")
    return 0


def cmd_validate(args) -> int:
    problems = validate(args.path)["problems"]
    if problems:
        print(f"INVALID ({len(problems)} problem(s)):")
        for p in problems:
            print(f"  {p}")
        return 1
    print(f"OK: {args.path} is a valid trace corpus file")
    return 0


def cmd_info(args) -> int:
    print(json.dumps(info(args.path), indent=1))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser("export", help="materialize a source into a corpus")
    ex.add_argument("source", help="source spec (synthetic app name, "
                                   "phased:a+b, corpus:path.npz)")
    ex.add_argument("out", help="output .npz path")
    ex.add_argument("--length", type=int, default=60_000)
    ex.add_argument("--n-cores", type=int, default=32)
    ex.add_argument("--seed", type=int, default=0)
    ex.add_argument("--ws-scale", type=float, default=1.0,
                    help="working-set scale (1/8 matches the simulator's "
                         "scaled memory system)")
    ex.set_defaults(fn=cmd_export)

    va = sub.add_parser("validate", help="check a corpus file")
    va.add_argument("path")
    va.set_defaults(fn=cmd_validate)

    nf = sub.add_parser("info", help="print metadata + trace statistics")
    nf.add_argument("path")
    nf.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
