"""The program's counters and spans.

**Counters.** :func:`count` adds to a named counter: a kernel wrapper's
launch into ``repro_torch.kernels.ops.launches`` (by kernel name), a
communicator's payload into :data:`counts` (``comm.all_to_all.bytes``,
``comm.all_gather.bytes``: bytes this process sends to other
processes). While a CUDA graph is captured nothing runs yet, so a count
made on the capturing stream goes into the capture's tally
(:func:`capture_tally`) instead, and each replay adds the tally back to
the counters it came from (:func:`add`). A backward kernel or exchange
runs on autograd's device thread, on the same capturing stream, and
counts into the same tally.

**Spans.** ``with span(name):`` adds the block's host-clock seconds and
one call to ``spans[name]`` (``{"seconds", "calls"}``); spans of one
name are not nested. While a ``torch.profiler`` runs, the block is also
a range of the profile, on the clock of its device operations, nested
in the ranges around it. The range is an operator-scope one: a
user-scope range (``record_function``) would also put a range on the
device's timeline, which a reading of the device's busy time would take
for work. With no profiler running no range is opened; the totals are
two clock reads and a dict update, so spans sit at set-up and step
granularity, never around a kernel.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import torch

counts: dict = {}                 # counter name -> total
spans: dict = {}                  # span name -> {"seconds", "calls"}

_tally: Optional[dict] = None     # the capture in progress, if any
_home: dict = {}                  # counter name -> the dict it counts in
_lock = threading.Lock()
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def count(name: str, n: int = 1, into: Optional[dict] = None) -> None:
    """Add ``n`` to counter ``name`` in ``into`` (default
    :data:`counts`), or to the capture's tally on a capturing stream."""
    into = counts if into is None else into
    if _tally is not None and torch.cuda.is_current_stream_capturing():
        _home[name] = into
        _tally[name] = _tally.get(name, 0) + n
    else:
        into[name] = into.get(name, 0) + n


def add(tally: dict) -> None:
    """Count one replay of a captured graph: each of its tally's counts
    into the counter it was made for."""
    for name, n in tally.items():
        into = _home.get(name, counts)
        into[name] = into.get(name, 0) + n


@contextlib.contextmanager
def capture_tally():
    """While a CUDA graph is captured: the counts made on the capturing
    stream go into the yielded dict, which each replay then adds
    (:func:`add`)."""
    global _tally
    prev, _tally = _tally, {}
    try:
        yield _tally
    finally:
        _tally = prev


class span:
    """``with span(name):``: see the module docstring."""

    __slots__ = ("name", "t", "rng")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rng = None
        if _Range is not None and torch.autograd._profiler_enabled():
            self.rng = _Range(self.name)
            self.rng.__enter__()
        self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t
        if self.rng is not None:
            self.rng.__exit__(*exc)
        with _lock:
            rec = spans.setdefault(self.name, {"seconds": 0.0, "calls": 0})
            rec["seconds"] += dt
            rec["calls"] += 1
        return False


__all__ = ["counts", "spans", "count", "add", "capture_tally", "span"]
