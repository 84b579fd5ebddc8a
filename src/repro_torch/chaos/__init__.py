"""Deterministic fault injection and recovery for fleet runs; counterpart
of `repro.chaos`.

Seeded fault schedules (`FaultPlan`), the chunk-boundary injection
runtime (`ChaosContext`), capacity-aware re-pricing (`ElasticGovernor`)
and chunk checkpoint and resume (`CheckpointConfig`, `resume_fleet`).
`run_all(..., chaos=, checkpoint=, resume=)` and `run_cluster(...)` route
such runs to the fleet's chunk loops.
"""
from .governor import ElasticGovernor
from .inject import (ChaosContext, ChaosExhausted, ChunkCorruptionDetected,
                     InjectedChunkFailure, SimulatedCrash, as_context)
from .plan import (EMPTY_PLAN, KINDS, FaultEvent, FaultPlan, from_faults,
                   generate)
from .recovery import (CheckpointConfig, ChunkCheckpointer, as_checkpoint,
                       check_fingerprint, pack_run_state, pack_state,
                       resume_cluster_fleet, resume_fleet, run_fingerprint,
                       unpack_run_state, unpack_state)

__all__ = [
    "KINDS", "FaultEvent", "FaultPlan", "EMPTY_PLAN", "from_faults",
    "generate", "ChaosContext", "as_context", "SimulatedCrash",
    "InjectedChunkFailure", "ChunkCorruptionDetected", "ChaosExhausted",
    "ElasticGovernor", "CheckpointConfig", "ChunkCheckpointer",
    "as_checkpoint", "pack_state", "unpack_state", "pack_run_state",
    "unpack_run_state", "check_fingerprint", "run_fingerprint",
    "resume_fleet", "resume_cluster_fleet",
]
