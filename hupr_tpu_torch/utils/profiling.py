"""Tracing / profiling helpers (counterpart of `hupr_tpu/utils/profiling.py`).

  with trace("logs/profile"):      # a Chrome trace (chrome://tracing,
      train_step(...)              # Perfetto) of the host's ops and the
                                   # card's kernels, via torch.profiler
  timer = StepTimer()
  with timer.step():
      ...
  timer.summary()                  # p50/p90/mean step latencies

torch.profiler drops some of the card's events from a window that opens
after the process has profiled once and then run unprofiled work on the
card, so a trace whose kernels are counted is the process's first.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the body, the host's ops and, where there is a
    card, its kernels; writes log_dir/trace_<pid>_<ns>.json (Chrome trace
    format) on exit and yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)


class StepTimer:
    def __init__(self):
        self.durations: List[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.durations.append(time.perf_counter() - t0)

    def summary(self) -> dict:
        if not self.durations:
            return {}
        import numpy as np

        d = np.asarray(self.durations)
        return {
            "steps": len(d),
            "mean_s": float(d.mean()),
            "p50_s": float(np.percentile(d, 50)),
            "p90_s": float(np.percentile(d, 90)),
            "total_s": float(d.sum()),
        }
