"""Training launcher of the port: random weights from the seed, the
reference's synthetic data stream, AdamW, checkpoints.

    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 100 \\
        [--resume] [--accum 2] [--compress-grads] [--no-remat]
    python -m repro_torch.launch.train --arch qwen2-0.5b-smoke --steps 4 \\
        --device cpu

The flags are `repro.launch.train`'s, plus ``--device`` (default cuda; a
missing card raises).  ``--arch`` takes every assigned architecture, the
audio encoder hubert-xlarge included, or ``<arch>-smoke`` for its reduced
twin.  Checkpoints go to ``--checkpoint-dir`` (default
``$TMPDIR/repro_torch_ckpt``) every ``--checkpoint-every`` steps and at the
end.  Prints a ``step ...`` line every 10 steps and a ``done: ...`` line.
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.training import AdamWConfig, TrainConfig, run_training
from repro_torch.training.train_loop import DEFAULT_CHECKPOINT_DIR


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    tcfg = TrainConfig(
        steps=args.steps, accum=args.accum, remat=not args.no_remat,
        compress_grads=args.compress_grads,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
    )
    dcfg = DataConfig(batch=args.batch, seq_len=args.seq_len)
    ocfg = AdamWConfig(lr=args.lr, total_steps=args.steps)
    res = run_training(cfg, tcfg, dcfg, ocfg, resume=args.resume,
                       device=device)
    final = res.losses[-1] if res.losses else float("nan")
    print(f"done: {res.final_step} steps, final loss {final:.4f}, "
          f"stragglers {res.straggler_events}, "
          f"resumed_from={res.resumed_from}")


if __name__ == "__main__":
    main()
