"""The program's own spans in a traced slice, read from the same
`torch.profiler` events as `timeline.read`: each device operation, and
each stretch in which the device idles, put down to the program span that
launched it.

A program span is a `record_function` range that `pcfa_tpu_torch` opens
(`utils/profiling.span`): `flow` and the names under `pcfa.`, `fgsm.`,
`lbfgs.`, `raft.` and `op.`. An operation's path is the chain of program
spans it ran under, outermost first, joined by '/'
(`pcfa.outer_step/lbfgs.iteration/pcfa.objective/flow/raft.refine`); the
backward's work carries `backward` after its forward spans
(`.../raft.refine/backward/op.corr_lookup.bwd`).

* Forward work: a device operation (kernel, copy, fill, as
  `timeline.LAUNCHES` defines them) goes to the program spans open on the
  launching thread at its launch call. The launch is found by its
  correlation id, and its time is the host's: no device timestamp is
  compared with a host one.
* Backward work: an operation launched inside an
  `autograd::engine::evaluate_function` event (the outermost one: a node
  may run a backward of its own inside) goes to the path of the forward
  operator that made the node (the same sequence number and forward
  thread), then `backward`, then the program spans opened inside the node
  (`op.small_conv.dx`, `op.corr_lookup.bwd`).
* Idle: each stretch of the slice with nothing on the device goes to the
  path of the launch that ends it; to `profiler` where the profiler's own
  work (`PROFILER_WORK`) ran on the host between the launch of the operation
  before the stretch and that launch; the last stretch to `end of slice`.
* Work under no program span is `unattributed`.

A program without spans gives a result with `found` false: every
operation unattributed.

The harness does not call `read` yet: a traced run keeps no profile past
`timeline.read`, and the per-layer metrics that would read these spans
wait on a `benchmark` change to `harness.py` and `run.py` (PERF.md §7).
Until then `benchmark/tests/test_bench_spans.py` runs it on a CPU
profile of the tiny cells.
"""

from __future__ import annotations

import bisect
import dataclasses

from torch.autograd import DeviceType

import timeline

UNATTRIBUTED = "unattributed"
BACKWARD = "backward"
PROFILER = "profiler"
END = "end of slice"
_PREFIXES = ("pcfa.", "fgsm.", "lbfgs.", "raft.", "op.")
_EVALUATE = "autograd::engine::evaluate_function"
#: the profiler's own work on the host (CUPTI's overhead records), by
#: name, compared without case and with '_' read as ' '
PROFILER_WORK = ("activity buffer request", "buffer flush",
                 "command buffer full", "instrumentation", "resource",
                 "runtime triggered module loading", "lazy function loading")
#: the engine's spans that hold the closure's network and backward
CLOSURE = ("pcfa.objective", "fgsm.objective")


def is_program(name: str) -> bool:
    return name == "flow" or name.startswith(_PREFIXES)


def _profiler_work(name: str) -> bool:
    return name.replace("_", " ").lower() in PROFILER_WORK


def parts(path: str) -> list[str]:
    return path.split("/")


@dataclasses.dataclass
class Spans:
    #: path → device seconds of the operations put down to it alone
    device_s: dict
    #: path → device operations put down to it
    launches: dict
    #: path (or `profiler`, `end of slice`) → idle seconds it ended
    idle_s: dict
    #: whether the slice holds any program span
    found: bool

    @property
    def unattributed_s(self) -> float:
        return self.device_s.get(UNATTRIBUTED, 0.0)

    def total_s(self) -> dict:
        """path → device seconds of the path and every path under it."""
        out: dict[str, float] = {}
        for path, s in self.device_s.items():
            p = parts(path)
            for i in range(1, len(p) + 1):
                key = "/".join(p[:i])
                out[key] = out.get(key, 0.0) + s
        return out

    def device_where(self, pred) -> float:
        return sum(s for path, s in self.device_s.items()
                   if path != UNATTRIBUTED and pred(parts(path)))

    def idle_where(self, pred) -> float:
        return sum(s for path, s in self.idle_s.items()
                   if path not in (UNATTRIBUTED, PROFILER, END)
                   and pred(parts(path)))


class _Nest:
    """Properly nested ranges of one thread, for point lookups: the
    innermost range holding a time, and its chain outward."""

    def __init__(self, ranges):
        # (start, end, payload), outer before inner at equal starts
        self.ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in self.ranges]
        self.parent, stack = [], []
        for i, (s, e, _) in enumerate(self.ranges):
            while stack and self.ranges[stack[-1]][1] < e:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def chain(self, t: int) -> list[int]:
        """Indices of the ranges holding `t`, innermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ranges[i][1] < t:
            i = self.parent[i]
        out = []
        while i >= 0:
            out.append(i)
            i = self.parent[i]
        return out


def _nests(ranges: dict) -> dict:
    return {thread: _Nest(r) for thread, r in ranges.items()}


def read(prof) -> Spans:
    """The slice's device time, launches and idle time by program span,
    from a finished `torch.profiler.profile` holding a `bench.slice`
    range."""
    events = prof.profiler.kineto_results.events()
    launch, device, host_names = {}, [], set()
    spans, nodes, overhead, forward = {}, {}, [], []
    s0 = s1 = None
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            device.append(e)
            continue
        name, start, thread = e.name(), e.start_ns(), e.start_thread_id()
        if timeline._runtime(name):
            launch[e.correlation_id()] = (name, start, thread)
            continue
        host_names.add(name)
        end = start + e.duration_ns()
        if name == "bench.slice":
            s0, s1 = start, end
        elif is_program(name):
            spans.setdefault(thread, []).append((start, end, name))
        elif name.startswith(_EVALUATE):
            nodes.setdefault(thread, []).append(
                (start, end, (e.fwd_thread_id(), e.sequence_nr())))
        elif _profiler_work(name):
            overhead.append((start, end))
        elif e.sequence_nr() >= 0:
            forward.append((start, thread, e.sequence_nr()))
    spans, nodes = _nests(spans), _nests(nodes)

    def span_chain(thread, t, after=None):
        """Names of the program spans open on `thread` at `t` (those that
        opened after `after` only), outermost first."""
        nest = spans.get(thread)
        if nest is None:
            return []
        return [nest.ranges[i][2] for i in reversed(nest.chain(t))
                if after is None or nest.ranges[i][0] >= after]

    def node(thread, t):
        nest = nodes.get(thread)
        chain = nest.chain(t) if nest is not None else []
        return nest.ranges[chain[-1]] if chain else None

    made = {}
    for start, thread, seq in sorted(forward):
        if node(thread, start) is None:
            made[(thread, seq)] = span_chain(thread, start)

    def path(at) -> str:
        _, t, thread = at
        n = node(thread, t)
        if n is None:
            chain = span_chain(thread, t)
        else:
            fwd = made.get(n[2], [])
            inner = span_chain(thread, t, after=n[0])
            chain = fwd + [BACKWARD] + inner if fwd or inner else []
        return "/".join(chain) or UNATTRIBUTED

    ops = []
    for e in device:
        at = timeline._launch(e, launch)
        if at is None or e.name() in host_names:
            continue
        start = e.start_ns()
        end = start + e.duration_ns()
        if s0 is not None and not (end > s0 and start < s1):
            continue
        ops.append((start, end, at))
    ops.sort(key=lambda o: o[0])
    overhead.sort()
    over_starts = [o[0] for o in overhead]

    def profiler_between(a: int, b: int) -> bool:
        """Whether the profiler's own work ran on the host within
        (a, b)."""
        i = bisect.bisect_left(over_starts, b)
        return any(overhead[j][1] > a for j in range(max(0, i - 8), i))

    device_s, launches, idle_s = {}, {}, {}
    busy_until = s0 if s0 is not None else (ops[0][0] if ops else 0)
    prev_launch = None
    for start, end, at in ops:
        p = path(at)
        device_s[p] = device_s.get(p, 0.0) + (end - start) * 1e-9
        launches[p] = launches.get(p, 0) + 1
        if start > busy_until:
            key = p
            if prev_launch is not None and profiler_between(prev_launch,
                                                            at[1]):
                key = PROFILER
            idle_s[key] = idle_s.get(key, 0.0) + (start - busy_until) * 1e-9
        busy_until = max(busy_until, end)
        prev_launch = at[1]
    if s1 is not None and s1 > busy_until:
        idle_s[END] = (s1 - busy_until) * 1e-9
    found = any(p != UNATTRIBUTED for p in device_s)
    return Spans(device_s, launches, idle_s, found)

