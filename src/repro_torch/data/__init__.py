"""Deterministic, seekable, per-host sharded input pipeline; counterpart
of `repro.data`."""
from .pipeline import DataPipeline, PipelineConfig, assemble, make_shard

__all__ = ["DataPipeline", "PipelineConfig", "assemble", "make_shard"]
