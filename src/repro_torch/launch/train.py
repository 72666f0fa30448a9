"""Training launcher.

A real run of a reduced config (2 layers, d_model 256) through the data
pipeline, the step and checkpoints, on cuda:0 (raises without CUDA):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 2

The production-mesh check of the full config (``launch.dryrun.run_one``
of train_4k on the abstract 16x16 mesh; nothing is allocated), which
prints the record as one JSON line:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --dry-run
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--dry-run", action="store_true",
                    help="run the full config's train_4k step once on the abstract "
                         "16x16 production mesh (meta shards: nothing is allocated) "
                         "and print its dry-run record")
    args = ap.parse_args(argv)

    if args.dry_run:
        import json

        from repro_torch.launch.dryrun import run_one
        from repro_torch.launch.mesh import make_production_mesh
        print(json.dumps(run_one(args.arch, "train_4k", make_production_mesh())))
        return 0

    from repro_torch.configs import get_config, reduced
    from repro_torch.training.loop import train
    cfg = reduced(get_config(args.arch), layers=2, d_model=256)
    report = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                   ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"done: final loss {report.losses[-1]:.4f} "
          f"({report.tokens_per_s:,.0f} tok/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
