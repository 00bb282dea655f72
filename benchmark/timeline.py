"""The device timeline of a traced slice, read from `torch.profiler`'s
events in memory (nothing is written to disk).

Each device operation (kernel, copy, fill) is tied, by the correlation id
the profiler records, to the host operation that launched it, and so to
the thread and the benchmark's own spans (`record_function` ranges named
`bench.*`) it was launched under. Work launched on another thread than the
benchmark's is autograd's backward, which runs on its own device thread.
"""

from __future__ import annotations

import bisect
import dataclasses

from torch.autograd import DeviceType

# what launches work on the device, by the name of the runtime call: the
# rest of the device timeline (the mirror of the host's annotations,
# synchronisation waits) is not work
LAUNCHES = ("Launch", "Memcpy", "Memset")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int          # ns
    end: int            # ns
    layer: str          # network, forward, backward, step, other


@dataclasses.dataclass
class Timeline:
    ops: list[DeviceOp]
    slice_start: int
    slice_end: int
    gaps: list           # (seconds, host op after the gap)
    kinds: dict          # device events kept and left out, by launch call

    @property
    def window_s(self) -> float:
        return (self.slice_end - self.slice_start) * 1e-9

    def time_s(self, pred) -> float:
        return 1e-9 * sum(o.end - o.start for o in self.ops if pred(o))

    def count(self, pred=lambda o: True) -> int:
        return sum(1 for o in self.ops if pred(o))

    def busy_s(self) -> float:
        """Seconds of the slice in which some device operation ran."""
        total, cur_s, cur_e = 0, None, None
        for o in sorted(self.ops, key=lambda o: o.start):
            s, e = max(o.start, self.slice_start), min(o.end, self.slice_end)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total * 1e-9


def _runtime(name: str) -> bool:
    """A call of the CUDA runtime or of its lower API (`cudaLaunchKernel`,
    `cuLaunchKernel`, `cudaMemcpyAsync`, …) rather than an operator or an
    annotation."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def _launch(e, launch: dict):
    """The runtime call that launched device event `e`: the launch, copy
    or fill call of the same correlation id; failing that, of the id the
    trace links it to, where that call began before it (the linked id is
    another count, so only the time tells a true match from a chance one).
    None for what no launch began: annotations mirrored on the device,
    synchronisation waits. (The device's clock is mapped onto the host's
    with a drift, so a device op can seem to start before its launch.)"""
    at = launch.get(e.correlation_id())
    if at is not None and any(w in at[0] for w in LAUNCHES):
        return at
    at = launch.get(e.linked_correlation_id())
    if at is not None and at[1] <= e.start_ns() \
            and any(w in at[0] for w in LAUNCHES):
        return at
    return None


class _Ranges:
    """Host ranges of one name on one thread, for point lookups."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s for s, _ in self.spans]

    def index(self, t: int) -> int | None:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.spans[i][1]:
            return i
        return None


def read(prof, flow_grad: list[bool]) -> Timeline:
    """The slice's timeline from a finished `torch.profiler.profile`.
    The slice is the `bench.slice` range, and its thread the benchmark's
    own; device work is classified by
    where its launch happened: under `bench.flow_fn` ('network' in a
    closure, 'forward' in a call without gradient; `flow_grad` says which
    the slice's calls were, in order), on another thread ('backward'),
    elsewhere under `bench.outer_step` or `bench.fgsm_step` ('step'), or
    elsewhere ('other')."""
    events = prof.profiler.kineto_results.events()
    main_thread = next(e.start_thread_id() for e in events
                       if e.name() == "bench.slice"
                       and e.device_type() != DeviceType.CUDA)
    host, launch, ranges, device_all = {}, {}, {}, []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            device_all.append(e)
            continue
        name, start, thread = e.name(), e.start_ns(), e.start_thread_id()
        if _runtime(name):
            launch[e.correlation_id()] = (name, start, thread)
            continue
        host[e.correlation_id()] = (name, start, thread)
        if name.startswith("bench.") and thread == main_thread:
            ranges.setdefault(name, []).append(
                (start, start + e.duration_ns()))
    (s0, s1), = ranges.pop("bench.slice")
    flow = _Ranges(ranges.get("bench.flow_fn", []))
    steps = _Ranges(ranges.get("bench.outer_step", [])
                    + ranges.get("bench.fgsm_step", []))
    ops, device, kinds = [], [], {}
    host_names = {h[0] for h in host.values()}
    for e in device_all:
        at = _launch(e, launch)
        if at is None or e.name() in host_names:
            key = f"left out: {e.name()[:40]}"
            kinds[key] = kinds.get(key, 0) + 1
            continue
        kinds[at[0]] = kinds.get(at[0], 0) + 1
        device.append(e)
        if at[2] != main_thread:
            layer = "backward"
        elif (i := flow.index(at[1])) is not None:
            layer = "network" if i >= len(flow_grad) or flow_grad[i] \
                else "forward"
        elif steps.index(at[1]) is not None:
            layer = "step"
        else:
            layer = "other"
        start = e.start_ns()
        ops.append(DeviceOp(e.name(), start, start + e.duration_ns(), layer))
    ops = [o for o in ops if o.end > s0 and o.start < s1]
    return Timeline(ops, s0, s1, _gaps(ops, s0, s1, device, host), kinds)


def _gaps(ops, s0, s1, device, host, top: int = 10):
    """The `top` longest stretches of the slice with nothing running on the
    device, each named by the host operation that launched the work that
    ended it (where the trace links the launch to one)."""
    launcher = {}
    for e in device:
        h = host.get(e.linked_correlation_id())
        launcher[e.start_ns()] = h[0] if h else e.name()
    gaps, busy_until = [], s0
    for o in sorted(ops, key=lambda o: o.start):
        if o.start > busy_until:
            gaps.append(((o.start - busy_until) * 1e-9,
                         launcher.get(o.start, o.name)))
        busy_until = max(busy_until, o.end)
    if s1 > busy_until:
        gaps.append(((s1 - busy_until) * 1e-9, "end of slice"))
    return sorted(gaps, reverse=True)[:top]
