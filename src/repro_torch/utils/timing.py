"""Wall-clock timing helpers (the counterpart of
``repro/utils/timing.py``). Host clock only: a caller timing work on the
card synchronizes the device first."""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class Timer:
    """Accumulating timer; use as context manager or .tic()/.toc()."""
    name: str = ""
    total_s: float = 0.0
    count: int = 0
    _t0: float = field(default=0.0, repr=False)

    def tic(self):
        self._t0 = time.perf_counter()
        return self

    def toc(self) -> float:
        dt = time.perf_counter() - self._t0
        self.total_s += dt
        self.count += 1
        return dt

    def __enter__(self):
        return self.tic()

    def __exit__(self, *exc):
        self.toc()
        return False

    @property
    def mean_us(self) -> float:
        return (self.total_s / max(self.count, 1)) * 1e6


@contextlib.contextmanager
def timed(sink: dict, key: str):
    """Add the block's wall seconds to ``sink[key]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink[key] = sink.get(key, 0.0) + (time.perf_counter() - t0)
