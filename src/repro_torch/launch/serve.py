"""Serving launcher: `python -m repro_torch.launch.serve --arch <id>`;
counterpart of `repro.launch.serve`, with the reference's flags,
`--full-config` (as the training launcher has it) and `--device`.

Greedy-decodes `--tokens` tokens after an 8-token prompt through the
`Engine` (flash attention in its prefill), then serves 100 requests
through the Chronos `HedgedScheduler` (one grid solve of the requests'
r*, then their draws: the grid-solve and Philox kernels on the card).
It prints one line for each.

Reduced configs (the default) have head dim 16, which the
flash-attention kernels do not take, so they run with `--device cpu`;
on the card run a full config, e.g. `--arch gemma2-2b --full-config`.

The reference builds `ReplicaPool(n_replicas=4, beta=1.4,
rng=np.random.default_rng(0))`, which raises TypeError: the pool is
frozen parameters and has no `rng` field (its draws are keyed per
request). The port builds the pool from its real fields.
"""
from __future__ import annotations

import argparse

from ..configs import get_config
from ..models.inputs import make_batch
from ..serve import Engine, HedgedScheduler, ReplicaPool, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (non-reduced) architecture")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    eng = Engine.build(cfg, max_seq=args.tokens + 16, device=args.device)
    batch = make_batch(cfg, args.batch, 8, "prefill", device=args.device)
    toks = eng.generate(batch, n_tokens=args.tokens)
    print(f"decoded {toks.shape} tokens on {cfg.name}")

    pool = ReplicaPool(n_replicas=4, beta=1.4)
    sched = HedgedScheduler(pool, theta=1e-2, device=args.device)
    reqs = [Request(deadline=0.6, rid=i, n_tokens=64) for i in range(100)]
    out = sched.run_workload(reqs)
    print(f"hedged SLA attainment: {out['pocd']:.3f} "
          f"(mean machine-time {out['mean_machine_time']:.3f}s)")


if __name__ == "__main__":
    main()
