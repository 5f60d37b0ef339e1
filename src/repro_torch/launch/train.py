"""Training launcher, after ``repro.launch.train``: runs the reduced (or,
with ``--full``, the whole) config through the fault-tolerant training
loop (``repro_torch.train.loop``): checkpointing, restart, straggler
monitoring.  On the CUDA card by default; ``--device cpu`` runs the
plain versions on the host.  Pod mode (``--mesh pod|multipod``) is the
reference's: the train step of ``--shape`` (full width) counted per chip
on the production mesh (``launch.dryrun.lower_cell`` on a fake process
group of 256 or 512 ranks), its roofline keys printed as JSON, then the
reference's NOTE unless ``--dry-run``; ``--dry-run``, which the
reference reads in pod mode only, changes nothing in host mode.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --steps 12 --device cpu
"""
import argparse
import json
import tempfile

# the report keys pod mode prints (the reference's)
POD_KEYS = ("arch", "shape", "mesh", "chips", "dominant", "t_compute_s",
            "t_memory_s", "t_collective_s", "roofline_fraction")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="full assigned config (pod mode)")
    ap.add_argument("--mesh", choices=("host", "pod", "multipod"),
                    default="host")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--dry-run", action="store_true",
                    help="pod mode: lower+compile only, print roofline")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    if args.mesh != "host":       # --dry-run alone is read in pod mode only
        from repro_torch.launch import dryrun as D
        rep = D.lower_cell(args.arch, args.shape,
                           multi_pod=args.mesh == "multipod",
                           microbatches=args.microbatches)
        print(json.dumps({k: rep[k] for k in POD_KEYS}, indent=1))
        if not args.dry_run:
            print("NOTE: execution on the production mesh requires real "
                  "TPU/TRN hosts; this container compiled the step "
                  "successfully and stopped (implicit --dry-run).")
        return

    from repro_torch import configs
    from repro_torch.train.loop import train

    cfg = configs.get(args.arch)
    cfg = cfg if args.full else cfg.reduced()
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_train_")
    print(f"train {cfg.name}: {args.steps} steps -> ckpt {ckpt}")
    state, losses, rep = train(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        ckpt_dir=ckpt, ckpt_every=max(args.steps // 3, 10),
        device=args.device)
    print(f"done: steps={rep.steps_run} restarts={rep.restarts} "
          f"stragglers={rep.stragglers} loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")


if __name__ == "__main__":
    main()
