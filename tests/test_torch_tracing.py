"""The port's spans and counters (`pcfa_tpu_torch/utils/profiling.py`).

Without a profiler a span is one shared null context and constructs no
`record_function`. Under the CPU profiler a test-size RAFT PCFA outer step
(`max_iter` 2, compact direction) and an I-FGSM step show every span of
`PERF.md`'s table, nested as documented; the counters count the calls
made; and every node of the closures' backward maps, by its sequence
number, to a forward operator under a program span: the attribution the
benchmark (`benchmark/spans.py`) builds on. The small conv takes its
`autograd.Function` with the plain versions in place of the kernels, as on
the card."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pcfa_tpu_torch.attack import fgsm, lbfgs, pcfa
from pcfa_tpu_torch.models import layers
from pcfa_tpu_torch.ops import small_conv as sc
from pcfa_tpu_torch.runtime import load_model, make_flow_fn
from pcfa_tpu_torch.utils import profiling

HW = (128, 128)
EVALUATE = "autograd::engine::evaluate_function: "
#: each span and the program spans it may open directly inside (None: at
#: the top); backward spans open inside a backward node instead
PARENTS = {
    "pcfa.init": {None},
    "pcfa.outer_step": {None},
    "lbfgs.iteration": {"pcfa.outer_step"},
    "pcfa.objective": {"lbfgs.iteration"},
    "lbfgs.push": {"lbfgs.iteration"},
    "lbfgs.direction": {"lbfgs.iteration"},
    "lbfgs.update": {"lbfgs.iteration"},
    "pcfa.bookkeeping": {"pcfa.outer_step"},
    "fgsm.step": {None},
    "fgsm.objective": {"fgsm.step"},
    "fgsm.update": {"fgsm.step"},
    "flow": {"pcfa.init", "pcfa.objective", "pcfa.bookkeeping",
             "fgsm.objective", "fgsm.update"},
    "raft.encoders": {"flow"},
    "raft.pyramid": {"flow"},
    "raft.refine": {"flow"},
    "raft.upsample": {"flow"},
    "op.small_conv": {"raft.encoders"},
    "op.corr_lookup": {"raft.refine"},
}
BACKWARD = {"op.small_conv.dx", "op.corr_lookup.bwd"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flow_fn():
    m = load_model("RAFT", init_random=True, seed=0, device="cpu", iters=2)
    return make_flow_fn(m, HW)[1]


def _inputs():
    g = torch.Generator().manual_seed(3)
    x1, x2 = (torch.rand((1, *HW, 3), generator=g) for _ in range(2))
    return x1, x2, torch.zeros((1, *HW, 2))


class _Event:
    def __init__(self, e):
        self.name, self.thread = e.name(), e.start_thread_id()
        self.start = e.start_ns()
        self.end = self.start + e.duration_ns()
        self.seq, self.fwd_thread = e.sequence_nr(), e.fwd_thread_id()
        self.parent = None

    def ancestors(self):
        a = self.parent
        while a is not None:
            yield a
            a = a.parent


def _events(prof) -> list[_Event]:
    """The profile's host events, each linked to the innermost event of
    its thread that holds it."""
    events = [_Event(e) for e in prof.profiler.kineto_results.events()]
    stack = []
    for e in sorted(events, key=lambda e: (e.thread, e.start, -e.end)):
        while stack and (stack[-1].thread != e.thread
                         or stack[-1].end < e.end):
            stack.pop()
        e.parent = stack[-1] if stack else None
        stack.append(e)
    return events


def _inner(e, names):
    """The innermost event holding `e` that `names` names, or None."""
    return next((a for a in e.ancestors() if a.name in names), None)


def _in_node(e) -> bool:
    return any(a.name.startswith(EVALUATE) for a in e.ancestors())


@pytest.fixture(scope="module")
def traced(flow_fn):
    """The events and counter changes of `pcfa_init`, one outer step and
    one I-FGSM step under the CPU profiler."""
    x1, x2, target = _inputs()
    cfg = pcfa.PCFAConfig(steps=1, max_iter=2, lbfgs_direction="compact")

    def through_function(x, weight, bias=None, stride=1, act=None):
        return sc._SmallConv.apply(x, weight, bias, stride, act)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "small_conv2d", through_function)
        mp.setattr(sc, "small_conv_fwd", sc.conv_plain)
        mp.setattr(sc, "small_conv_dx", sc.conv_dx_plain)
        before = profiling.counters()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            state, init = pcfa.pcfa_init(flow_fn, x1, x2, cfg, "cpu")
            pcfa.pcfa_outer_step(flow_fn, x1, x2, target, init, state, cfg)
            fgsm.fgsm_step(flow_fn, x1, x2, target, init, (x1, x2),
                           fgsm.FGSMConfig())
        after = profiling.counters()
    events = _events(prof)
    # the counters that moved: others the process counted before stay out
    delta = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    return events, delta


def test_span_without_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    names = [*PARENTS, *BACKWARD]
    assert all(profiling.span(n) is profiling._NO_SPAN for n in names)
    # the instrumented code runs with no span constructed
    x = torch.randn(2, 5, dtype=torch.float64)
    state = lbfgs.lbfgs_init(x, 3)
    for pos in range(2):
        state, _ = lbfgs.lbfgs_iteration(
            lambda v: ((v * v).sum(1), 2 * v), state, pos,
            direction="compact")
    with profiling.span("flow"), profiling.span("flow"):
        pass


def test_counters_are_host_integers(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a counter synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiling.count("test.calls")
        profiling.count("test.calls", 4)
    snap = profiling.counters()
    assert snap["test.calls"] - before.get("test.calls", 0) == 5
    snap["test.calls"] = -1
    assert profiling.counters()["test.calls"] != -1
    assert not [e.name() for e in prof.profiler.kineto_results.events()
                if e.name().startswith(("aten::", "cuda"))]


def test_every_counted_kernel_wrapper_is_registered():
    """Each kernel wrapper of `pcfa_tpu_torch/ops` that counts its launches
    (`.launches`) is marked by `profiling.launch_counted`, the list whose
    counts a CUDA-graph replay credits (`utils/graphs.py`)."""
    import importlib
    import pkgutil

    from pcfa_tpu_torch import ops

    found = set()
    for m in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{m.name}")
        found |= {f for f in vars(mod).values()
                  if callable(f) and hasattr(f, "launches")}
    assert len(found) >= 9
    assert found <= set(profiling.launch_counted_wrappers())


def test_every_span_appears_nested_as_documented(traced):
    events, _ = traced
    spans = [e for e in events if e.name in PARENTS or e.name in BACKWARD]
    assert {e.name for e in spans} == set(PARENTS) | BACKWARD
    flows = {}
    for e in spans:
        if e.name in BACKWARD:
            assert _in_node(e), e.name
            continue
        parent = _inner(e, PARENTS)
        assert (parent.name if parent else None) in PARENTS[e.name], (
            e.name, parent and parent.name)
        if e.name == "flow":
            flows[parent.name] = flows.get(parent.name, 0) + 1
    assert flows == {"pcfa.init": 1, "pcfa.objective": 2,
                     "pcfa.bookkeeping": 1, "fgsm.objective": 1,
                     "fgsm.update": 1}
    assert sum(e.name == "lbfgs.iteration" for e in spans) == 2


def test_counters_count_the_calls(traced):
    _, delta = traced
    assert delta["flow.closures"] == 3        # two L-BFGS, one I-FGSM
    assert delta["flow.forwards"] == 3        # init, bookkeeping, I-FGSM
    assert delta["lbfgs.iterations"] == 2
    assert delta["raft.corr_impl.materialized"] == 6
    assert not {k for k in delta if k.startswith("raft.corr_impl.")} - {
        "raft.corr_impl.materialized"}


def test_backward_nodes_map_to_forward_spans(traced):
    """Every node of the closures' backward (a node outside any other: on
    the CPU the plain lookup's backward runs a backward of its own inside
    its node) maps to the forward operator of its sequence number and
    thread, and that lies under a program span."""
    events, _ = traced
    nodes = [e for e in events if e.name.startswith(EVALUATE)
             and not e.name.endswith("AccumulateGrad") and not _in_node(e)]
    assert nodes
    forward = {}
    for e in sorted(events, key=lambda e: e.start):
        if e.seq >= 0 and not e.name.startswith(EVALUATE) \
                and not _in_node(e):
            forward[(e.thread, e.seq)] = e
    under_flow = 0
    for n in nodes:
        op = forward.get((n.fwd_thread, n.seq))
        assert op is not None, n.name
        span = _inner(op, PARENTS)
        assert span is not None, (n.name, op.name)
        under_flow += span.name.startswith(("raft.", "op.", "flow"))
    assert under_flow > len(nodes) // 2


#: PWCNet's spans and the program span each opens directly inside
PWC_PARENTS = {"pwcnet.pyramid": {"flow"}, "pwcnet.level": {"flow"},
               "pwcnet.context": {"flow"}, "pwcnet.upsample": {"flow"},
               "op.local_corr": {"pwcnet.level"}}
PWC_BACKWARD = {"op.local_corr.bwd", "op.warp.bwd"}


@pytest.fixture(scope="module")
def pwc_traced():
    """The events and counter changes of one PWCNet closure (the flow and
    its backward to both frames) and one forward without gradient, at
    64×64, under the CPU profiler; the correlation takes its
    `autograd.Function` with the plain versions in place of the kernels,
    as on the card."""
    from pcfa_tpu_torch.models import pwcnet
    from pcfa_tpu_torch.ops import local_corr as lc

    m = load_model("PWCNet", init_random=True, seed=0, device="cpu")
    flow_fn = make_flow_fn(m, (64, 64))[1]
    g = torch.Generator().manual_seed(4)
    x1, x2 = (torch.rand((1, 64, 64, 3), generator=g).requires_grad_(True)
              for _ in range(2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pwcnet, "local_corr", lc._LocalCorr.apply)
        mp.setattr(lc, "local_corr_fwd", lc.local_corr_plain)
        mp.setattr(lc, "local_corr_bwd", lc.local_corr_bwd_plain)
        before = profiling.counters()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            flow_fn(x1, x2).square().sum().backward()
            with torch.no_grad():
                flow_fn(x1, x2)
        after = profiling.counters()
    # the counters that moved: others the process counted before stay out
    delta = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    return _events(prof), delta


def test_pwcnet_spans_open_as_documented(pwc_traced):
    """Per forward: the pyramid, the context net and the upsampling once,
    a level span for each of the five levels, a correlation in each; per
    closure's backward five correlation and four warp backwards, each
    inside a backward node."""
    events, _ = pwc_traced
    names = set(PARENTS) | set(PWC_PARENTS)
    seen = {}
    for e in events:
        if e.name in PWC_BACKWARD:
            assert _in_node(e), e.name
        elif e.name in PWC_PARENTS:
            parent = _inner(e, names)
            assert parent is not None and parent.name in PWC_PARENTS[
                e.name], (e.name, parent and parent.name)
        else:
            continue
        seen[e.name] = seen.get(e.name, 0) + 1
    assert seen == {"pwcnet.pyramid": 2, "pwcnet.level": 10,
                    "pwcnet.context": 2, "pwcnet.upsample": 2,
                    "op.local_corr": 10, "op.local_corr.bwd": 5,
                    "op.warp.bwd": 4}
    flows = [e for e in events if e.name == "flow"]
    assert len(flows) == 2
    for level in (e for e in events if e.name == "pwcnet.level"):
        assert sum(e.name == "op.local_corr" and _inner(e, names) is level
                   for e in events) == 1


def test_pwcnet_op_counters_count_per_closure(pwc_traced):
    _, delta = pwc_traced
    assert delta["flow.closures"] == 1 and delta["flow.forwards"] == 1
    assert delta["local_corr.fwd"] == 10      # five levels, two forwards
    assert delta["local_corr.bwd"] == 5       # the closure's backward
    assert delta["warp.bwd"] == 4             # levels 5 to 2
