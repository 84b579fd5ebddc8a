"""Runtime telemetry of the port; counterpart of `repro.runtime`. Only
`DurationWindow` is ported (the storage of `obs.tail`); the rest of the
runtime waits for its slice (ROADMAP.md)."""
from .telemetry import DurationWindow

__all__ = ["DurationWindow"]
