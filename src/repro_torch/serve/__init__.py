"""Serving of the port; counterpart of `repro.serve`. Only the text
engine (`Engine`: prefill, then greedy decode) is ported; the hedged
scheduler and the online loop wait for the serving slice (ROADMAP.md)."""
from .engine import Engine

__all__ = ["Engine"]
