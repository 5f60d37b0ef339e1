"""End-to-end training on the PyTorch port: data pipeline -> train loop ->
checkpoint -> restart, with the fault-tolerance supervisor; the twin of
``examples/train_lm.py``.

Defaults are a reduced config, 60 steps.  ``--model-100m`` trains the
~100M-param member of the family, ``--full`` the full assigned config
(one process: a mesh is ``repro_torch.launch.train``'s job).  On the card
each step runs the flash forward and backward kernels.

  PYTHONPATH=src python examples/torch_train_lm.py --device cpu
  PYTHONPATH=src python examples/torch_train_lm.py --arch mamba2-780m \\
      --steps 40
  PYTHONPATH=src python examples/torch_train_lm.py --model-100m --steps 300

``run(cfg, ...)`` returns what the script prints as a dict (both calls'
losses and reports, and ms a step).  The weights are drawn from a
``torch.Generator`` seeded 0 (``train.loop.train``); ``init`` (the
reference's tree as numpy arrays) replaces them.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from dataclasses import replace

from repro_torch import configs
from repro_torch.train.loop import train


def build_cfg(args) -> configs.ArchConfig:
    cfg = configs.get(args.arch)
    if args.full:
        return cfg
    if args.model_100m:
        # ~100M-param member of the same family (paper-scale example (b))
        pat = len(cfg.block_pattern)
        reps = max(1, 12 // pat)
        return replace(cfg.reduced(), name=cfg.name + "-100m",
                       d_model=768, num_layers=pat * reps, num_heads=12,
                       num_kv_heads=4, d_ff=2048, vocab_size=32_000,
                       head_dim=64)
    return cfg.reduced()


def run(cfg, *, steps: int = 60, batch: int = 8, seq: int = 128,
        lr: float = 3e-4, microbatches: int = 1,
        grad_compression: bool = False, ckpt_dir=None, device=None,
        init=None, log=lambda line: None) -> dict:
    """Train ``cfg`` for ``steps`` steps with checkpoints, assert that the
    loss fell, then resume from the latest checkpoint for a few more;
    ``log`` receives each printed line (the train loop's too)."""
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    log(f"training {cfg.name}: {steps} steps, batch {batch}, "
        f"seq {seq}, ckpt -> {ckpt_dir}")
    t0 = time.perf_counter()
    _, losses, report = train(
        cfg, steps=steps, batch=batch, seq=seq, lr=lr,
        microbatches=microbatches, grad_compression=grad_compression,
        ckpt_dir=ckpt_dir, ckpt_every=max(steps // 3, 10), device=device,
        init=init, print_fn=log)
    seconds = time.perf_counter() - t0

    log(f"\nsteps run      : {report.steps_run}")
    log(f"first loss     : {losses[0]:.4f}")
    log(f"last loss      : {losses[-1]:.4f}")
    assert losses[-1] < losses[0], "loss should decrease on synthetic data"
    log("loss decreased — training works end to end.")

    # --- restart-from-checkpoint (fault-tolerance path): num_steps is the
    # target global step, so ask for a few more than already completed
    extra = max(steps // 6, 5)
    log(f"\nsimulating restart from the latest checkpoint "
        f"(+{extra} steps) ...")
    t1 = time.perf_counter()
    _, losses2, rep2 = train(
        cfg, steps=steps + extra, batch=batch, seq=seq, lr=lr,
        ckpt_dir=ckpt_dir, ckpt_every=10_000, device=device, init=init,
        print_fn=log)
    seconds2 = time.perf_counter() - t1
    log(f"resumed at step {rep2.resumed_from} and ran {rep2.steps_run} "
        f"more steps (loss {losses2[-1]:.4f}); checkpoint/restart works.")
    return {"name": cfg.name, "losses": losses, "steps_run": report.steps_run,
            "seconds": seconds, "ms_per_step": 1e3 * seconds / steps,
            "resumed_from": rep2.resumed_from,
            "resumed_steps_run": rep2.steps_run, "resumed_losses": losses2,
            "resumed_seconds": seconds2, "ckpt_dir": ckpt_dir}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b",
                    choices=sorted(configs.ALL_ARCHS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true",
                    help="int8 + error-feedback gradient compression")
    ap.add_argument("--model-100m", action="store_true",
                    help="~100M-param family member instead of reduced")
    ap.add_argument("--full", action="store_true",
                    help="full assigned config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions")
    args = ap.parse_args(argv)
    run(build_cfg(args), steps=args.steps, batch=args.batch, seq=args.seq,
        lr=args.lr, microbatches=args.microbatches,
        grad_compression=args.grad_compression, ckpt_dir=args.ckpt_dir,
        device=args.device, log=print)


if __name__ == "__main__":
    main()
