"""Inspect / pin / replay-verify autotuner trajectory files on the
PyTorch port; the twin of ``tools/autotune_trajectory.py``.

  PYTHONPATH=src python tools/torch_autotune_trajectory.py info TRAJ.jsonl
  PYTHONPATH=src python tools/torch_autotune_trajectory.py crc TRAJ.jsonl ...
  PYTHONPATH=src python tools/torch_autotune_trajectory.py verify TRAJ.jsonl

``info`` prints the header and per-generation best curve.  ``crc``
prints the crc32 of the raw bytes (the golden-pin primitive — byte
determinism, not just value determinism).  ``verify`` rebuilds the
(space, agent, seed) from the header and replays every logged
generation through the port's agent (``autotune.tuner.replay_agent``),
exiting 1 if any proposal diverges from the log.  Replay feeds the
logged scores back, so verification costs zero simulator dispatches and
no device.  A trajectory either package wrote, the other's tool reads
with the same output.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.autotune import (TrajectoryError,  # noqa: E402
                                  read_trajectory, replay_agent,
                                  trajectory_crc)


def info(path) -> dict:
    doc = read_trajectory(path)
    h = doc["header"]
    return {"path": str(path), "agent": h["agent"], "seed": h["seed"],
            "pop": h["pop"], "objective": h["objective"],
            "space": {name: len(vals) for name, vals in h["space"]},
            "best_scores": [g["best_score"] for g in doc["generations"]]}


def crc(path) -> int:
    return trajectory_crc(path)


def verify(path) -> dict:
    """{"ok": True, generations, best} or {"ok": False, "error"}."""
    try:
        agent = replay_agent(path)
    except TrajectoryError as e:
        return {"ok": False, "error": str(e)}
    return {"ok": True, "generations": agent.generation,
            "best": agent.best_score}


def cmd_info(paths) -> int:
    for p in paths:
        d = info(p)
        print(f"{p}: agent={d['agent']} seed={d['seed']} pop={d['pop']} "
              f"objective={d['objective']}")
        space = d["space"]
        print(f"  space: {space} "
              f"({'x'.join(str(n) for n in space.values())} points)")
        curve = " ".join(f"{s:.4f}" for s in d["best_scores"])
        print(f"  {len(d['best_scores'])} generations, best-so-far: {curve}")
    return 0


def cmd_crc(paths) -> int:
    for p in paths:
        print(f"{crc(p):10d}  {p}")
    return 0


def cmd_verify(paths) -> int:
    bad = 0
    for p in paths:
        r = verify(p)
        if not r["ok"]:
            print(f"FAIL {p}: {r['error']}", file=sys.stderr)
            bad += 1
            continue
        print(f"ok {p}: {r['generations']} generations replayed "
              f"bit-identically (best {r['best']:.4f})")
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("command", choices=("info", "crc", "verify"))
    ap.add_argument("files", nargs="+")
    args = ap.parse_args(argv)
    return {"info": cmd_info, "crc": cmd_crc,
            "verify": cmd_verify}[args.command](args.files)


if __name__ == "__main__":
    raise SystemExit(main())
