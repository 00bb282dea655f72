"""The attribution of a traced slice to the program's spans
(`spans.py`), on the CPU: the tiny RAFT cells run traced, their CPU
profile read as a device timeline (`standin.py`) by `timeline.read` and
by `spans.read`, and the program's counters read on both sides of the
slice."""

from __future__ import annotations

import os

import pytest
import torch

import harness
import spans
import timeline
from conftest import tiny_cell
from pcfa_tpu_torch.utils import profiling
from standin import StandIn


@pytest.fixture(scope="module")
def traced():
    """{cell: the traced run's output, with its `spans` and `counters`
    (the program's, over the slice)} of the tiny PCFA and I-FGSM cells."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("PCFA_")]:
            mp.delenv(key)
        read_tl, launch_counts = timeline.read, harness._launch_counts
        got, snaps = {}, []

        def read(prof, calls):
            got["spans"] = spans.read(StandIn(prof))
            return read_tl(StandIn(prof), calls)

        def counts(kernels):
            # read where the slice starts and where it ends
            snaps.append(profiling.counters())
            return launch_counts(kernels)

        mp.setattr(timeline, "read", read)
        mp.setattr(harness, "_launch_counts", counts)
        for name in ("raft-pcfa-kitti-b2", "raft-ifgsm-kitti-b2"):
            extra = {"steps": 2} if "ifgsm" in name else {}
            got.clear()
            snaps.clear()
            run = harness.run(tiny_cell(name, **extra), 11, 0.0, True,
                              torch.device("cpu"), 0.0)
            first, last = snaps
            run["spans"] = got["spans"]
            run["counters"] = {k: v - first.get(k, 0)
                               for k, v in last.items()}
            out[name] = run
    return out


@pytest.mark.parametrize("name", ["raft-pcfa-kitti-b2",
                                  "raft-ifgsm-kitti-b2"])
def test_every_launch_goes_to_one_span(traced, name):
    out = traced[name]
    tl, sp = out["timeline"], out["spans"]
    assert sp.found and tl.count() > 0
    assert sum(sp.launches.values()) == tl.count()
    assert sum(sp.device_s.values()) == pytest.approx(
        tl.time_s(lambda o: True), rel=1e-9)
    total = sp.total_s()
    for path in sp.device_s:
        under = sum(s for p, s in sp.device_s.items()
                    if p == path or p.startswith(path + "/"))
        assert total[path] == pytest.approx(under, rel=1e-9)
    # the slice is busy or idle, and every idle stretch goes somewhere
    assert sum(sp.idle_s.values()) == pytest.approx(
        tl.window_s - tl.busy_s(), rel=1e-6, abs=1e-9)
    # what runs outside the program's spans: the benchmark's own few
    # operations between steps, and the I-FGSM attack's images
    assert sp.unattributed_s < 0.05 * sum(sp.device_s.values())


def test_backward_goes_to_the_forward_spans(traced):
    sp = traced["raft-pcfa-kitti-b2"]["spans"]
    closure = "pcfa.outer_step/lbfgs.iteration/pcfa.objective/flow"
    paths = set(sp.device_s)
    assert f"{closure}/raft.refine/backward/op.corr_lookup.bwd" in paths
    assert f"{closure}/raft.refine/backward" in paths
    assert "pcfa.outer_step/lbfgs.iteration/pcfa.objective/backward" in paths
    assert f"{closure}/raft.refine/op.corr_lookup" in paths
    for name in ("lbfgs.push", "lbfgs.direction", "lbfgs.update"):
        assert f"pcfa.outer_step/lbfgs.iteration/{name}" in paths
    assert not [p for p in paths if p.startswith("autograd")]


def test_counters_match_the_slice(traced):
    for name, out in traced.items():
        w, c = out["window"], out["counters"]
        assert c["flow.closures"] == w.slice_closures > 0
        assert c["flow.forwards"] == w.slice_forwards > 0
        assert c["raft.corr_impl.materialized"] == len(w.slice_calls)
        if "pcfa" in name:
            assert c["lbfgs.iterations"] == w.slice_closures
        else:
            assert "lbfgs.iterations" not in c or not c["lbfgs.iterations"]


def test_the_spans_sit_inside_the_timeline_layers(traced):
    """The L-BFGS alone (`lbfgs.iteration` outside its objective) is part
    of what `timeline` puts under the step; RAFT's refinement in the
    closures, forward and backward, part of the network and its backward;
    the idle ended under `flow` and under the engine outside it part of
    all the slice's idle."""
    for name, out in traced.items():
        tl, sp = out["timeline"], out["spans"]
        lbfgs = sp.device_where(lambda p: "lbfgs.iteration" in p
                                and "pcfa.objective" not in p)
        step = tl.time_s(lambda o: o.layer == "step")
        if "pcfa" in name:
            assert 0 < lbfgs < step
        else:
            assert lbfgs == 0
        refine = sp.device_where(lambda p: "raft.refine" in p and any(
            c in p for c in spans.CLOSURE))
        assert 0 < refine < tl.time_s(
            lambda o: o.layer in ("network", "backward"))
        networks = sp.idle_where(lambda p: "flow" in p)
        engine = sp.idle_where(lambda p: "flow" not in p and any(
            c.startswith(("lbfgs.", "pcfa.", "fgsm.")) for c in p))
        assert 0 < networks and 0 <= engine
        assert networks + engine <= sum(sp.idle_s.values()) + 1e-12


def test_a_program_without_spans_reads_as_unattributed():
    """The parent's program: no span, so every operation unattributed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.slice"):
            (x @ x).relu().sum()
    sp = spans.read(StandIn(prof))
    assert not sp.found and set(sp.device_s) == {spans.UNATTRIBUTED}
    assert sp.launches[spans.UNATTRIBUTED] >= 3


class _Fake:
    """A kineto event with the fields the readers use."""

    def __init__(self, name, start, end, thread=1, corr=0, linked=0,
                 device=False):
        self.v = (name, start, end - start, thread, corr, linked, device)

    def name(self):
        return self.v[0]

    def start_ns(self):
        return self.v[1]

    def duration_ns(self):
        return self.v[2]

    def start_thread_id(self):
        return self.v[3]

    def correlation_id(self):
        return self.v[4]

    def linked_correlation_id(self):
        return self.v[5]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self.v[6] else DeviceType.CPU

    def sequence_nr(self):
        return -1

    def fwd_thread_id(self):
        return 0


class _Profile:
    def __init__(self, events):
        self.profiler = self.kineto_results = self
        self._events = events

    def events(self):
        return self._events


def test_a_mirrored_span_is_not_device_work():
    """A span's mirror on the device timeline (an annotation, named as the
    host range) is not work, even where the range shares its correlation
    id with a later host event and the mirror's linked id meets a launch:
    one kernel, one launch."""
    prof = _Profile([
        _Fake("bench.slice", 0, 1000),
        _Fake("pcfa.outer_step", 10, 900),
        _Fake("aten::add", 20, 30),
        _Fake("cudaLaunchKernel", 21, 24, corr=7),
        _Fake("void add_kernel", 40, 50, corr=7, device=True),
        _Fake("pcfa.outer_step", 25, 880, linked=7, device=True),
    ])
    sp = spans.read(prof)
    assert sp.launches == {"pcfa.outer_step": 1}
    assert sp.device_s == {"pcfa.outer_step": pytest.approx(10e-9)}
