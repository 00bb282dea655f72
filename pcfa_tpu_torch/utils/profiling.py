"""Tracing and timing hooks (`pcfa_tpu/utils/profiling.py`).

* `trace(logdir)`: `torch.profiler` over the block (CPU, and CUDA when the
  card is there), written as a Chrome trace into `logdir`.
* `debug_nans()`: opt-in anomaly detection (`torch.autograd.
  set_detect_anomaly`), which raises where a backward produces NaN.
* `fence()` and `StepTimer`: wall-clock step timing that waits for the
  card (`torch.cuda.synchronize()`) before reading the clock, since CUDA
  launches return before the work is done.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; the trace lands in `logdir/trace.json`
    (chrome://tracing or Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        fence()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def debug_nans():
    with torch.autograd.set_detect_anomaly(True):
        yield


def fence() -> None:
    """Wait for the work queued on the card (nothing to wait for on the
    CPU, whose ops run synchronously)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class StepTimer:
    """Accumulates fenced per-step wall times.

    >>> t = StepTimer()
    >>> with t.step():
    ...     out = attack_fn(x)
    """

    times: list = field(default_factory=list)

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        fence()
        self.times.append(time.perf_counter() - t0)

    def fenced(self, fn, *args):
        """Run fn(*args), wait for the card, record the duration."""
        t0 = time.perf_counter()
        out = fn(*args)
        fence()
        self.times.append(time.perf_counter() - t0)
        return out

    @property
    def total(self) -> float:
        return sum(self.times)

    @property
    def mean(self) -> float:
        return self.total / len(self.times) if self.times else 0.0

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        return {
            "steps": len(self.times),
            "mean_s": self.mean,
            "min_s": min(self.times),
            "max_s": max(self.times),
            "total_s": self.total,
        }
