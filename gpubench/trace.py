"""The traced run: torch.profiler over the tail of the window, and what the
per-layer readers and the `breakdown` take from it.

The profiler is opened once a process, after the measured window: a
process that has profiled runs its later host launches slower, and a
second profiler window drops some of the card's events.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

# idle seconds inside the profiler's window before and after the traced
# work, so that the card's events at its edges are kept
TRACE_PAD_S = 0.25
SPAN = "gpubench.tail"
TOP = 10


@dataclass
class Trace:
    """The traced span: its wall seconds and units of work, the card's
    kernels [(name, start_us, end_us)], the host's launch calls, the
    seconds the card was busy (the union of its events' spans), and the
    breakdown."""
    wall_s: float
    units: int
    frames: int
    kernels: list
    host_launches: int
    busy_s: float
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def _union(spans):
    """Sorted, merged (start, end) intervals."""
    out = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _host_activity(cpu, starts, t):
    """The name of the innermost host op running at time t, or 'python'
    where no op of torch's runs (the interpreter between calls)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 400, -1), -1):
        start, end, name = cpu[j]
        if end >= t:
            return name
    return "python"


def read(prof, wall_s: float, units: int, frames: int) -> Trace:
    """The Trace of a profiler run whose work ran inside a record_function
    named SPAN."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    # the span shows twice: the host's range and its mirror on the card
    span = [e for e in events if e.name == SPAN and e.device_type != cuda]
    lo, hi = ((span[0].time_range.start, span[0].time_range.end) if span
              else (float("-inf"), float("inf")))
    kernels, cpu, launches = [], [], 0
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.name == SPAN:
            continue
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False):
                continue        # a host range mirrored on the card
            kernels.append((e.name, start, end))
        else:
            cpu.append((start, end, e.name))
            if "Launch" in e.name:
                launches += 1
    busy = _union((s, e) for _, s, e in kernels)
    busy_s = sum(e - s for s, e in busy) / 1e6
    by_name = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:TOP]
    cpu.sort()
    starts = [c[0] for c in cpu]
    gaps, cursor = {}, lo
    if span:
        for s, e in busy + [[hi, hi]]:
            s = min(max(s, lo), hi)
            if s > cursor:
                name = _host_activity(cpu, starts, (cursor + s) / 2)
                gaps[name] = gaps.get(name, 0.0) + (s - cursor) / 1e6
            cursor = max(cursor, min(e, hi))
    idle = sorted(gaps.items(), key=lambda x: -x[1])[:TOP]
    return Trace(wall_s=wall_s, units=units, frames=frames, kernels=kernels,
                 host_launches=launches, busy_s=busy_s,
                 device_ops=[[n[:160], s] for n, s in ops],
                 idle_gaps=[[n[:160], s] for n, s in idle])


def traced(work, units: int, frames: int) -> Trace:
    """`work()` once under torch.profiler (host and card), the card idle
    and the window padded on both sides; `units` and `frames` are the work
    it does."""
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card
                                           else [])
    if card:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        time.sleep(TRACE_PAD_S)
        with record_function(SPAN):
            t0 = time.perf_counter()
            work()
            if card:
                torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        time.sleep(TRACE_PAD_S)
    return read(prof, wall_s, units, frames)
