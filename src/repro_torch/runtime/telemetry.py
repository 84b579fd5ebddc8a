"""Task and request duration telemetry: the data the tail governor fits
Pareto to; counterpart of `repro.runtime.telemetry` (`DurationWindow`
only, copied: it is host Python with no framework in it)."""
from __future__ import annotations

import threading
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
