"""Host-side span tracing; counterpart of `repro.obs.trace`.

Stage boundaries of the pipeline (workload synthesis, jobset build, each
strategy's run, the optimizer's solves) wrap themselves in `span(...)`.
Spans nest through a per-thread stack, carry free-form attributes and
record perf_counter_ns timestamps; `obs.export` writes them as a Chrome
trace or a text summary.

Dispatch against execution: PyTorch launches CUDA work asynchronously, so
the wall time of a call covers host work and enqueueing while the card
runs behind it. `fenced(...)` therefore records a `kind="dispatch"` span
around the call and, when its output holds CUDA tensors, a
`kind="execute"` span around `torch.cuda.synchronize`. The reference
flags recompiles from jit's cache size, which has no torch meaning; here
the dispatch span gets `built=True` when `kernels/build.py` compiled a
CUDA source with nvcc during the call.

The tracer is off by default: `span(...)` returns a shared no-op context
and `fenced` is a plain call with no synchronize, so an untraced run
launches exactly what it would without this module. `profile(...)` wraps
`torch.profiler` for the device-level timeline.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

__all__ = ["Span", "Tracer", "enable", "disable", "enabled", "get_tracer",
           "span", "fenced", "profile"]


@dataclass
class Span:
    """One closed (or still-open) interval of the host timeline."""
    name: str
    start_ns: int
    end_ns: Optional[int] = None
    kind: str = "stage"            # "stage" | "dispatch" | "execute"
    attrs: dict = field(default_factory=dict)
    depth: int = 0
    tid: int = 0

    @property
    def duration_ns(self) -> int:
        end = (self.end_ns if self.end_ns is not None
               else time.perf_counter_ns())
        return end - self.start_ns


class _SpanCtx:
    """Context manager recording one Span on the owning tracer."""
    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span_: Span):
        self._tracer = tracer
        self.span = span_

    def set(self, **attrs):
        self.span.attrs.update(attrs)
        return self

    def __enter__(self):
        self._tracer._push(self.span)
        return self

    def __exit__(self, *exc):
        self._tracer._pop(self.span)
        return False


class _NoopCtx:
    """Shared do-nothing span: the cost of a disabled span is one attribute
    load and two no-op calls."""
    __slots__ = ()
    span = None

    def set(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopCtx()


class Tracer:
    """Collects spans from any thread; nesting depth is tracked per-thread
    so concurrent host threads (e.g. async checkpoint writers) interleave
    without corrupting each other's stacks."""

    def __init__(self):
        self.spans: list[Span] = []
        self.t0_ns: int = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- span recording ----------------------------------------------------
    def span(self, name: str, kind: str = "stage", **attrs) -> _SpanCtx:
        return _SpanCtx(self, Span(name=name, start_ns=0, kind=kind,
                                   attrs=dict(attrs)))

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, sp: Span):
        st = self._stack()
        sp.depth = len(st)
        sp.tid = threading.get_ident()
        sp.start_ns = time.perf_counter_ns()
        st.append(sp)

    def _pop(self, sp: Span):
        sp.end_ns = time.perf_counter_ns()
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        with self._lock:
            self.spans.append(sp)

    # -- views -------------------------------------------------------------
    def closed_spans(self) -> list[Span]:
        with self._lock:
            return list(self.spans)

    def wall_ns(self) -> int:
        """Wall-clock between the first span start and the last span end."""
        spans = self.closed_spans()
        if not spans:
            return 0
        return (max(s.end_ns for s in spans if s.end_ns is not None)
                - min(s.start_ns for s in spans))

    def clear(self):
        with self._lock:
            self.spans.clear()
        self.t0_ns = time.perf_counter_ns()


# ---------------------------------------------------------------------------
# Module-level switch: one global tracer, enabled explicitly
# ---------------------------------------------------------------------------

_TRACER = Tracer()
_ENABLED = False


def enable(fresh: bool = True) -> Tracer:
    """Turn span collection on (optionally clearing prior spans)."""
    global _ENABLED
    if fresh:
        _TRACER.clear()
    _ENABLED = True
    return _TRACER


def disable() -> Tracer:
    global _ENABLED
    _ENABLED = False
    return _TRACER


def enabled() -> bool:
    return _ENABLED


def get_tracer() -> Tracer:
    return _TRACER


def span(name: str, kind: str = "stage", **attrs):
    """The instrumentation entry every pipeline stage uses.

    Disabled: returns a shared no-op context manager (no allocation beyond
    the kwargs dict the caller built). Enabled: records a Span on the
    global tracer.
    """
    if not _ENABLED:
        return _NOOP
    return _TRACER.span(name, kind=kind, **attrs)


def _cuda_devices(out, found=None) -> set:
    """The CUDA devices of the tensors in `out` (nested tuples, lists,
    dicts and NamedTuples)."""
    found = set() if found is None else found
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _cuda_devices(v, found)
    return found


def fenced(name: str, fn, /, *args, **kwargs):
    """Call `fn(*args, **kwargs)` under a dispatch span; when its output
    holds CUDA tensors, wait for the card under an execute span
    (`<name>.wait`).

    With tracing disabled this is a plain call with no synchronize. The
    dispatch span gets `built=True` when an nvcc build ran inside it.
    """
    if not _ENABLED:
        return fn(*args, **kwargs)
    from ..kernels import build
    before = build.compiles
    with _TRACER.span(name, kind="dispatch") as sp:
        out = fn(*args, **kwargs)
        if build.compiles > before:
            sp.set(built=True)
    devices = _cuda_devices(out)
    if devices:
        with _TRACER.span(f"{name}.wait", kind="execute"):
            for dev in devices:
                torch.cuda.synchronize(dev)
    return out


@contextlib.contextmanager
def profile(log_dir: str):
    """Opt-in deep dive: run the region under `torch.profiler` (CPU, and
    the card's kernels where one is visible) and write its Chrome trace to
    `log_dir/torch_trace.json`. Never enabled implicitly: profiling has
    real overhead."""
    from pathlib import Path
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with span("torch.profiler", log_dir=str(log_dir)):
        with torch_profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(str(Path(log_dir) / "torch_trace.json"))
