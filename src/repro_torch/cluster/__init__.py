"""Finite-capacity cluster replay; counterpart of `repro.cluster`.

The flat Monte-Carlo pipeline (`repro_torch.sim`) has infinite capacity:
every attempt finds a free slot at its launch time. This package replays
the same traces, with the same draws, through a bounded slot pool with
FIFO or EDF dispatch, exposing queueing delay, utilization and what
speculation costs under load. On the card the dispatch recursion is the
hand-written kernel `kernels/csrc/dispatch_scan.cu`.

    from repro_torch.cluster import run_cluster
    outs, r_min = run_cluster(Philox(0), jobs, SimParams(), slots=500)

`run_cluster(..., slots=None)` reproduces `sim.run_all` draw for draw.
Every entry point takes `device=` and runs on the card by default.
"""
from .admission import (AdmissionConfig, GovernorConfig, admit_jobs,
                        apply_governor, offered_load)
from .engine import (ClusterOutput, QueueMetrics, build_strategy_table,
                     replay, run_cluster, run_cluster_strategy)
from .events import (AttemptTable, Realized, dispatch_scan, masked_dispatch,
                     predicted_holds, realize)
from .slots import (DISCIPLINES, SlotPool, dispatch_key_order, make_pool,
                    utilization)

__all__ = [
    "AdmissionConfig", "AttemptTable", "ClusterOutput", "DISCIPLINES",
    "GovernorConfig", "QueueMetrics", "Realized", "SlotPool", "admit_jobs",
    "apply_governor", "build_strategy_table", "dispatch_key_order",
    "dispatch_scan", "make_pool", "masked_dispatch", "offered_load",
    "predicted_holds", "realize", "replay", "run_cluster",
    "run_cluster_strategy", "utilization",
]
