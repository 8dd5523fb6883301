"""The traced window's reduction: ``torch.profiler`` over the window, then
the device operations (name, start, end), the device's busy time (the
union of their intervals), the idle gaps between them labelled by the
host operation that ran across each, and the largest operations."""
from __future__ import annotations

import bisect
from collections import defaultdict


def profiler(on_card: bool):
    """A profiler over the host and, on the card, the device."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _union(spans):
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(prof, top: int = 10) -> dict:
    """``{"device_ops": [(name, start_us, end_us), ...], "busy_s",
    "largest": [[name, seconds], ...], "idle_gaps": [[label, seconds],
    ...]}`` of a finished profile."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            dev.append((e.name, start, end))
        elif e.device_type == DeviceType.CPU and end > start:
            host.append((start, end, e.name))
    merged = _union((a, b) for _, a, b in dev)
    busy_us = sum(b - a for a, b in merged)
    by_name = defaultdict(float)
    for name, a, b in dev:
        by_name[name[:120]] += (b - a) / 1e6
    largest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:200]
    host.sort()
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for length, a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        # the innermost host operation running across the gap's middle
        inner = None
        for s, e, name in reversed(host[max(0, i - 2000):i]):
            if e >= mid and (inner is None or e - s < inner[1] - inner[0]):
                inner = (s, e, name)
        label = inner[2][:120] if inner else "(no host operation traced)"
        idle[label] += length / 1e6
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": dev, "busy_s": busy_us / 1e6,
            "largest": [[k, v] for k, v in largest],
            "idle_gaps": [[k, v] for k, v in idle_gaps]}


def cuda_seconds(fn, launches: int = 50, warmup: int = 3) -> float:
    """Seconds a call of ``fn`` takes on the card: CUDA events around
    ``launches`` calls after ``warmup`` more, over the count."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / launches
