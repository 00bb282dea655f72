"""A CPU profile read as a device timeline, so that the readers of a
traced slice (`timeline.read`, `spans.read`) run on the CPU.

Each innermost operator on the host stands for a launch at its start, on
its thread, and for the device operation that launch made, with the
operator's own start and duration. Autograd runs a CPU backward on the
thread that asked for it; on the card it runs on a thread of its own, and
so it does here: every event inside an outermost
`autograd::engine::evaluate_function` event moves to a thread of its
own."""

from __future__ import annotations

from torch.autograd import DeviceType

_EVALUATE = "autograd::engine::evaluate_function"
#: added to a thread's id for the thread its backward moves to
BACKWARD_THREAD = 1 << 40
_FIRST_ID = 1 << 50


class _Event:
    def __init__(self, name, start, duration, thread, correlation=0,
                 device=DeviceType.CPU, seq=-1, fwd_thread=0):
        self._v = (name, start, duration, thread, correlation, device, seq,
                   fwd_thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return 0

    def device_type(self):
        return self._v[5]

    def sequence_nr(self):
        return self._v[6]

    def fwd_thread_id(self):
        return self._v[7]


def _copy(e, thread: int) -> _Event:
    return _Event(e.name(), e.start_ns(), e.duration_ns(), thread,
                  e.correlation_id(), e.device_type(), e.sequence_nr(),
                  e.fwd_thread_id())


class StandIn:
    """`prof`'s events with a launch and a device operation for each
    innermost operator; `profiler.kineto_results.events()` as a
    `torch.profiler.profile` has it."""

    def __init__(self, prof):
        events = sorted(prof.profiler.kineto_results.events(),
                        key=lambda e: (e.start_thread_id(), e.start_ns(),
                                       -e.duration_ns()))
        out, stack, leaves = [], [], {}
        for e in events:
            name, thread = e.name(), e.start_thread_id()
            end = e.start_ns() + e.duration_ns()
            while stack and (stack[-1]["thread"] != thread
                             or stack[-1]["end"] < end):
                stack.pop()
            backward = name.startswith(_EVALUATE) or bool(
                stack and stack[-1]["backward"])
            moved = _copy(e, thread + BACKWARD_THREAD if backward
                          else thread)
            out.append(moved)
            op = name.startswith("aten::")
            if op:
                outer = next((s for s in reversed(stack) if s["op"]), None)
                if outer is not None:
                    leaves.pop(id(outer["event"]), None)
                leaves[id(moved)] = moved
            stack.append({"thread": thread, "end": end, "op": op,
                          "backward": backward, "event": moved})
        for i, leaf in enumerate(leaves.values()):
            name, start, duration, thread = leaf._v[:4]
            out.append(_Event("cudaLaunchKernel", start, 1, thread,
                              _FIRST_ID + i))
            out.append(_Event(f"stand-in {name}", start, duration, 0,
                              _FIRST_ID + i, DeviceType.CUDA))
        self._events = out

    @property
    def profiler(self):
        return self

    @property
    def kineto_results(self):
        return self

    def events(self):
        return self._events
