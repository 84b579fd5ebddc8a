"""Training launcher: `python -m repro_torch.launch.train --arch <id> ...`;
counterpart of `repro.launch.train`, with the reference's flags and
`--device`.

Reduced configs (the default) have head dim 16, which the flash-attention
kernels do not take, so they run with `--device cpu`; on the card run a
full config, e.g. `--arch gemma2-2b --full-config` (the largest dense
config whose f32 parameters, AdamW moments and gradients fit in 80 GB).
"""
from __future__ import annotations

import argparse

from ..configs import get_config
from ..train import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (non-reduced) architecture")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--no-speculation", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    tcfg = TrainerConfig(n_steps=args.steps, global_batch=args.batch,
                         seq_len=args.seq, n_micro=2, ckpt_dir=args.ckpt_dir,
                         data_cycle=8,
                         speculative_input=not args.no_speculation)
    t = Trainer(cfg, tcfg, seed=0, device=args.device)
    if args.ckpt_dir:
        resumed = t.maybe_restore()
        if resumed:
            print(f"resumed from step {resumed}")
    hist = t.run()
    print(f"done: {len(hist)} steps, final loss {hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
