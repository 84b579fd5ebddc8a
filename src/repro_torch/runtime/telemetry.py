"""Task, step and request duration telemetry: the data the governors fit
Pareto to; counterpart of `repro.runtime.telemetry`, copied (host Python
with no framework in it)."""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class DurationWindow:
    """Thread-safe rolling window of observed durations (seconds)."""
    capacity: int = 512
    _buf: deque = field(default_factory=deque)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def __post_init__(self):
        # the deque's maxlen follows `capacity`
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        self._buf = deque(self._buf, maxlen=self.capacity)

    def record(self, seconds: float):
        with self._lock:
            self._buf.append(float(seconds))

    def snapshot(self):
        with self._lock:
            return list(self._buf)

    def __len__(self):
        with self._lock:
            return len(self._buf)


class Telemetry:
    """Named duration windows and counters for the whole runtime."""

    def __init__(self):
        self.windows: dict[str, DurationWindow] = {}
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()

    def window(self, name: str, capacity: int = 512) -> DurationWindow:
        """Get or create the named window (`capacity` applies on create)."""
        with self._lock:
            if name not in self.windows:
                self.windows[name] = DurationWindow(capacity=capacity)
            return self.windows[name]

    def bump(self, name: str, by: int = 1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + by

    def timer(self, name: str):
        """A context manager recording its body's wall seconds into the
        named window."""
        tel = self

        class _T:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                tel.window(name).record(time.perf_counter() - self.t0)

        return _T()
