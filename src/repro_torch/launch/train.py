"""Training launcher: --arch <id> [--smoke] with checkpointing/restart.

The reference's CLI, flag for flag, on one device: the card unless
``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-1b \
        --steps 3 --seq 2048 --batch 4
"""
from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the card (cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models.registry import get_config, get_smoke_config
    from repro_torch.train import train

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if not args.smoke:
        cfg = cfg.scaled(remat="none")  # single-host example scale
    run = RunConfig(
        model=cfg, shape=ShapeConfig("cli", args.seq, args.batch, "train"),
        learning_rate=args.lr, optimizer=args.optimizer,
        microbatch=args.microbatch,
        gradient_compression=args.grad_compression)
    res = train(run, device=args.device, num_steps=args.steps,
                checkpoint_dir=args.ckpt, checkpoint_every=args.ckpt_every,
                resume=args.resume, log_every=1)
    print(f"finished {res.steps} steps; final loss {res.final_loss:.4f}")


if __name__ == "__main__":
    main()
