"""Tracing and timing hooks (`pcfa_tpu/utils/profiling.py`).

* `trace(logdir)`: `torch.profiler` over the block (CPU, and CUDA when the
  card is there), written as a Chrome trace into `logdir`. The trace shows
  the program's own spans (`span`) around the attack's parts, the networks'
  stages and the kernels, beside the operators and device work under them.
* `span(name)`: a `torch.profiler.record_function` range named `name`
  while a torch profiler runs (`trace`, or any `torch.profiler.profile`),
  else one shared context that does nothing: one flag check, no
  allocation. There is no other switch: spans are on exactly while someone
  profiles. Off, a span's with-block costs about 0.5 µs on a CPU core; on,
  about 21 µs of host time beside an H100 (one tiny launch per span).
* `count(name, n)` and `counters()`: integers on the host, counted whether
  or not a profiler runs (no device work, no synchronisation), and a
  snapshot of them. The names in use: `flow.closures` and `flow.forwards`
  (calls of `runtime.make_flow_fn`'s flow function with and without
  gradient recording), `flow.graph_captures` and `flow.graph_replays`
  (for a network replayed from CUDA graphs, `utils/graphs.py`: input keys
  captured, a closure's forward and backward graphs counted as one, and
  flow-function calls answered by a replay), `lbfgs.iterations`
  (`lbfgs_iteration` calls), `raft.corr_impl.<impl>` (RAFT and GMA
  forwards by the correlation path `resolve_corr_impl` chose),
  `local_corr.fwd` and `local_corr.bwd`
  (the patch correlation's autograd forwards and backwards,
  `ops/local_corr.py`: one kernel launch each) and `warp.bwd` (the
  packed sampler's backwards, `ops/segsum.warp_bwd`: on the card one
  kernel launch each).
* `launch_counted(fn)`: marks a hand-written kernel's launching wrapper,
  which adds 1 to its `.launches` at each launch; `launch_counted_wrappers()`
  lists them all (`utils/graphs.py` credits them on a replay).
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
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

#: what `span` returns while no profiler runs
_NO_SPAN = contextlib.nullcontext()
_COUNTERS: dict[str, int] = {}
_LAUNCH_COUNTED: list = []


def span(name: str):
    """A context that marks its block as the program span `name` in a
    profile: `record_function(name)` while a torch profiler runs, else the
    shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add `n` to the host counter `name`."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> dict[str, int]:
    """A snapshot of the counters: {name: count since the process began}."""
    return dict(_COUNTERS)


def launch_counted(fn):
    """Gives the kernel-launching wrapper `fn` its `.launches` (0), which
    `fn` adds 1 to at each launch, and lists it in
    `launch_counted_wrappers`."""
    fn.launches = 0
    _LAUNCH_COUNTED.append(fn)
    return fn


def launch_counted_wrappers() -> tuple:
    """The wrappers `launch_counted` marked."""
    return tuple(_LAUNCH_COUNTED)


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
