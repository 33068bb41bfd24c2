"""Tracing helpers (counterpart of `hupr_tpu/utils/profiling.py`): the
program's spans and counters, and the operator's exporter.

  with trace("logs/profile"):      # a Chrome trace (chrome://tracing,
      train_step(...)              # Perfetto) of the host's ops and the
                                   # card's kernels, via torch.profiler,
                                   # and the span table beside it
  with annotate("hupr.train.step"):
      ...                          # a span, recorded while a profiler is
  count("hupr.collectives")        # recording; a counter, the same
  table()                          # per name: count, host_s, self_host_s,
                                   # device_s; and the counters

A span costs one read of torch's profiler flag while no profiler records:
`annotate` then hands back one shared no-op context, and `count` and
`count_h2d` (the bytes a copy in takes from host memory) return.
While one records, a span opens `torch.profiler.record_function(name)`
(so the trace shows it) and appends to an in-memory table its name, host
start and end, the id of its enclosing span and of its outermost one (the
request, step or frame it belongs to). Host times are time.time_ns(): the
profiler's CPU events are stamped on that clock (CLOCK_REALTIME, ns since
the epoch, on Linux), so the table lines up with the trace. A span with
`device=True` also records a pair of CUDA events on the current stream,
read when the table is, except while that stream is capturing a graph.
Counters and the table take a lock: autograd's backward thread counts too.

Span names are `hupr.*` and hold neither `Launch` nor `nccl`, which the
benchmark's trace readers match.

torch.profiler drops some of the card's events from a window that opens
after the process has profiled once and then run unprofiled work on the
card, so a trace whose kernels are counted is the process's first.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _torch_profiler

_LOCK = threading.Lock()
_SPANS: list = []       # [name, start_ns, end_ns, id, parent, root, device]
_COUNTERS: dict = {}
_IDS = itertools.count(1)
_OPEN = threading.local()     # this thread's open spans, outermost first


class _NoSpan:
    """The span while no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "device", "record", "row")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()
        start = time.time_ns()      # next to the profiler's own stamp
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        span_id = next(_IDS)
        events = None
        if self.device and not torch.cuda.is_current_stream_capturing():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        self.row = [self.name, start, 0, span_id,
                    stack[-1].row[3] if stack else None,
                    stack[0].row[3] if stack else span_id, events]
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.row[2] = time.time_ns()
        if self.row[6] is not None:
            self.row[6][1].record()
        _OPEN.stack.pop()
        with _LOCK:
            _SPANS.append(self.row)
        return self.record.__exit__(*exc)


def annotate(name: str, device: bool = False):
    """The program's span `name` around a with-block. `device=True` (the
    block's work is on the card) also times the block's work on the
    current stream."""
    if not _torch_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while a profiler records."""
    if not _torch_profiler._is_profiler_enabled:
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def count_h2d(*arrays) -> None:
    """Add to the counter `hupr.h2d_bytes` the bytes of `arrays` that lie
    in host memory (numpy arrays', CPU tensors'; a card tensor's or None's
    are none), while a profiler records."""
    if not _torch_profiler._is_profiler_enabled:
        return
    total = 0
    for x in arrays:
        if isinstance(x, torch.Tensor):
            total += 0 if x.is_cuda else x.numel() * x.element_size()
        else:
            total += int(getattr(x, "nbytes", 0))
    count("hupr.h2d_bytes", total)


def reset() -> None:
    """Empty the table and the counters."""
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()


def _device_s(events) -> float | None:
    """A device span's seconds on its stream (None if not recorded)."""
    if events is None:
        return None
    if isinstance(events, float):
        return events
    events[1].synchronize()
    return events[0].elapsed_time(events[1]) / 1e3


def _covered(spans) -> int:
    """ns covered by the union of (start, end) intervals."""
    total, cursor = 0, None
    for start, end in sorted(spans):
        if cursor is None or start > cursor:
            total += end - start
            cursor = end
        elif end > cursor:
            total += end - cursor
            cursor = end
    return total


def spans() -> list:
    """Every recorded span, in the order they closed: dicts of name,
    start_ns, end_ns, id, parent, root and device_s (None for a host
    span), the device events read here."""
    with _LOCK:
        rows = list(_SPANS)
    out = []
    for row in rows:
        row[6] = _device_s(row[6])
        out.append(dict(zip(("name", "start_ns", "end_ns", "id", "parent",
                             "root", "device_s"), row)))
    return out


def table() -> dict:
    """{"spans": {name: {count, host_s, self_host_s[, device_s]}},
    "counters": {name: n}}: a span's self time is its duration less what
    its child spans cover of it; device_s only for device spans."""
    rows = spans()
    children: dict = {}
    for r in rows:
        children.setdefault(r["parent"], []).append(r)
    out: dict = {}
    for r in rows:
        start, end = r["start_ns"], r["end_ns"]
        kids = [(max(c["start_ns"], start), min(c["end_ns"], end))
                for c in children.get(r["id"], ())]
        entry = out.setdefault(r["name"], {"count": 0, "host_s": 0.0,
                                           "self_host_s": 0.0})
        entry["count"] += 1
        entry["host_s"] += (end - start) / 1e9
        entry["self_host_s"] += (end - start - _covered(
            k for k in kids if k[1] > k[0])) / 1e9
        if r["device_s"] is not None:
            entry["device_s"] = entry.get("device_s", 0.0) + r["device_s"]
    with _LOCK:
        counters = dict(_COUNTERS)
    return {"spans": out, "counters": counters}


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the body, the host's ops and, where there is a
    card, its kernels; yields the profiler. On exit writes
    log_dir/trace_<pid>_<ns>.json (Chrome trace format) and, beside it,
    spans_<pid>_<ns>.json: the body's spans and the table (the table is
    emptied on entry)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    stem = f"{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stem}.json"))
    with open(os.path.join(log_dir, f"spans_{stem}.json"), "w") as f:
        json.dump({"spans": spans(), "table": table()}, f)
