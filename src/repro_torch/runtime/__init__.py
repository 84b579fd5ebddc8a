"""Runtime substrates of the port: telemetry, the Chronos StepGovernor
and speculative host tasks; counterpart of `repro.runtime`. `elastic`
shrinks a mesh of ranks and re-shards a state onto the new plan.

The governor and the runner resolve lazily: `obs.tail` imports this
package's telemetry while `core` (which the governor needs) is still
importing `obs`."""
from .telemetry import DurationWindow, Telemetry

__all__ = ["DurationWindow", "GovernorConfig", "ProgressBoard",
           "SpeculativeTaskRunner", "StepGovernor", "TaskResult",
           "Telemetry"]

_LAZY = {"GovernorConfig": "governor", "StepGovernor": "governor",
         "ProgressBoard": "speculation", "SpeculativeTaskRunner":
         "speculation", "TaskResult": "speculation"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
