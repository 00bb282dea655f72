"""One run of one cell: set-up, the measured window, the traced slice, the
check against the reference, and the metrics.

The window is a closed loop of attacks: the next attack starts when the
previous one ends, each on fresh pairs. It starts at the first attack's
first call (`pcfa_init`, or I-FGSM's first forward) and ends at the first
step boundary after `seconds`; the benchmark synchronises the device once
per step to timestamp it, and nothing else differs from the program's own
loop. With `trace`, a fixed slice of whole steps (the attack loop's `slice`)
runs under `torch.profiler`, kept in memory, and the per-layer metrics are
read from it.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import statistics
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

import cells
import check
import flops
import synthetic
import timeline
import weights
from reference import common


class BenchFlow:
    """The flow function handed to the engine: the program's, under a
    `bench.flow_fn` span, counting its calls. For the judged attack it
    keeps, from the first call that records a gradient, the flow and the
    gradient that reaches the two network inputs, and from the next `arm`
    − 1 such calls the flow."""

    def __init__(self, flow_fn, pairs: list[int]):
        self.flow_fn, self.pairs = flow_fn, pairs
        self.grad_calls: list[bool] = []
        self.arm = 0
        self.kept: dict = {}

    def __call__(self, x1, x2):
        with record_function("bench.flow_fn"):
            grad = torch.is_grad_enabled() and (x1.requires_grad
                                                or x2.requires_grad)
            self.grad_calls.append(grad)
            out = self.flow_fn(x1, x2)
            if grad and self.arm:
                self.arm -= 1
                self._keep(x1, x2, out)
            return out

    def _keep(self, x1, x2, out):
        idx = torch.tensor(self.pairs, device=out.device)
        flows = self.kept.setdefault("closure_flows", [])
        flows.append(out.detach().index_select(0, idx))
        if len(flows) > 1:
            return

        def hook(slot):
            def keep(g):
                self.kept[slot] = g.detach().index_select(0, idx).clone()
            return keep

        x1.register_hook(hook("g1"))
        x2.register_hook(hook("g2"))


@dataclasses.dataclass
class Window:
    steps: int = 0
    failed: int = 0
    attacks: int = 0
    start: float = 0.0
    step_ends: list = dataclasses.field(default_factory=list)
    #: (closures, forwards) of each step, the attack's start in its first
    step_calls: list = dataclasses.field(default_factory=list)
    slice_s: float | None = None
    slice_first: int = 0
    slice_steps: int = 0
    slice_closures: int = 0
    slice_forwards: int = 0
    launches: dict = dataclasses.field(default_factory=dict)
    slice_calls: list = dataclasses.field(default_factory=list)

    def untraced(self) -> list[tuple[float, int, int]]:
        """(seconds, closures, forwards) of each step of the window that
        ran without the profiler: all but the traced slice's steps and the
        step after it, which pays for the profiler's close."""
        ends = [self.start] + self.step_ends
        traced = range(self.slice_first, self.slice_first + self.slice_steps
                       + 1) if self.slice_steps else range(0)
        return [(ends[i + 1] - ends[i], *self.step_calls[i])
                for i in range(len(self.step_ends)) if i not in traced]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launch_counts(kernel_modules: dict) -> dict:
    """{kernel: {counter: launches}} read from the program's counters."""
    out = {}
    for name, mod in kernel_modules.items():
        out[name] = {k: getattr(getattr(importlib.import_module(m), attr),
                                "launches", 0)
                     for k, (m, attr) in mod.COUNTERS.items()}
    return out


def _diff(after: dict, before: dict) -> dict:
    return {n: {k: v - before[n][k] for k, v in c.items()}
            for n, c in after.items()}


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_process: float) -> dict:
    """Run the cell once: a dict of what the result and the lines before
    it print (`correct`, `attempted`, `failed`, `metrics`, `checks`,
    `window`, `memory_peak_bytes`, and with `trace` the `timeline`)."""
    from pcfa_tpu_torch import runtime
    from pcfa_tpu_torch.ops import _build

    cfg, traffic = cell.config, cell.traffic
    pairs, hw = traffic["pairs"], tuple(cfg["image_hw"])
    if device.type == "cuda":
        _build.build()
    ref_module = cells.module("reference", cfg["reference"], cell.root)

    def reference():
        return getattr(ref_module, cfg["reference_class"])(**cfg["model"])

    with torch.device("meta"):
        published = reference()
    path = os.path.join(tempfile.gettempdir(), "pcfa-benchmark",
                        f"{cfg['name']}.pth")
    weights.save(weights.make(published, seed, device, **cfg["weights"]),
                 path, cfg["checkpoint_container"])
    loaded = runtime.load_model(cfg["net"], checkpoint=path, device=device,
                                **cfg["model"])
    padder, program_flow = runtime.make_flow_fn(loaded, hw,
                                                pad_mode=cfg["pad_mode"])
    judged = check.sample_pairs(seed, pairs, traffic["checked_pairs"])
    flow = BenchFlow(program_flow, judged)
    runner = cells.module("attacks", traffic["attack"], cell.root).Runner(
        flow, cfg["net"], traffic, device)
    kernel_modules = {k: cells.module("kernels", k, cell.root)
                      for k in cfg.get("kernel_calls", {})}
    target = torch.zeros((pairs, *hw, 2), device=device)

    def batch(first_pair):
        return synthetic.batch(seed, first_pair, pairs, hw,
                               traffic["max_shift"])

    def on_device(images):
        return padder.pad(*(torch.from_numpy(x).to(device) for x in images))

    # the warm-up's pairs come from indices that no attack of the window
    # reaches
    runner.warm_up(*on_device(batch(1 << 40)), target)
    images = judged_images = batch(0)
    _sync(device)

    w, tracer = Window(), _Tracer(trace, runner.slice, flow, kernel_modules,
                                  device)
    answers = {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    w.start = time.perf_counter()
    setup_s = w.start - t_process
    calls = len(flow.grad_calls)
    done = False
    while not done:
        tracer.maybe_start(w.steps)
        att = runner.start(*on_device(images), target)
        flow.arm = min(2, runner.closures_per_step) if w.attacks == 0 else 0
        for s in range(runner.steps):
            tracer.maybe_start(w.steps)
            with record_function(runner.span):
                aee, l2, flow_step = att.step()
            _sync(device)
            w.failed += not bool(torch.isfinite(torch.stack([aee, l2])).all())
            w.steps += 1
            w.step_ends.append(time.perf_counter())
            grads = flow.grad_calls[calls:]
            calls = len(flow.grad_calls)
            w.step_calls.append((sum(grads), len(grads) - sum(grads)))
            if w.attacks == 0 and s == 0:
                answers = _program_answers(att, flow, judged, aee, l2,
                                           flow_step)
            del flow_step
            tracer.maybe_stop(w)
            if w.step_ends[-1] - w.start >= seconds and tracer.done:
                done = True
                break
        w.attacks += 1
        del att
        if not done:
            images = batch(w.attacks * pairs)

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del runner, program_flow, loaded, target
    flow.flow_fn = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"setup_s": setup_s, "window": w, "memory_peak_bytes": peak,
           "pairs": pairs, "steps_per_attack": traffic["steps"],
           "config": cfg}
    if trace:
        out["timeline"] = timeline.read(tracer.prof, w.slice_calls)
        out["flops"] = flops.per_pair(
            reference, padder.padded_shape, hw,
            common.pad_amounts(hw, cfg["pad_divisor"], cfg["pad_mode"]))
        tracer.prof = None
    numbers = _judge(cfg, traffic, ref_module, path, judged_images, answers,
                     device)
    os.remove(path)
    correct, shown = check.verdict(
        numbers, cfg["limits"].get(traffic["attack"], {}), w.failed)
    out.update(correct=correct, checks=shown, attempted=w.steps,
               failed=w.failed)
    out["metrics"] = _metrics(cell, out, trace)
    return out


class _Tracer:
    """The traced slice: `torch.profiler` from before global step
    `first` to the end of step `first + n − 1`, with the launch counters
    and the flow function's calls read on both sides."""

    def __init__(self, on, slice_, flow, kernel_modules, device):
        self.on, (self.first, self.n) = on, slice_
        self.flow, self.kernels, self.device = flow, kernel_modules, device
        self.prof = self.range = None
        self.done = not on

    def maybe_start(self, steps: int) -> None:
        if not self.on or self.prof is not None or steps != self.first:
            return
        _sync(self.device)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.counts = _launch_counts(self.kernels)
        self.calls = len(self.flow.grad_calls)
        self.range = record_function("bench.slice")
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def maybe_stop(self, w: Window) -> None:
        if self.prof is None or self.done or w.steps != self.first + self.n:
            return
        self.range.__exit__(None, None, None)
        _sync(self.device)
        w.slice_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        w.launches = _diff(_launch_counts(self.kernels), self.counts)
        w.slice_calls = self.flow.grad_calls[self.calls:]
        w.slice_closures = sum(w.slice_calls)
        w.slice_forwards = len(w.slice_calls) - w.slice_closures
        w.slice_first, w.slice_steps = self.first, self.n
        self.done = True


def _program_answers(att, flow: BenchFlow, judged, aee, l2,
                     flow_step) -> dict:
    """The judged pairs' answers of the first step, on the host: the first
    forward's flow, the first closure's loss and input gradient, the flows
    of the step's closures that were kept, the attack's state after the step
    (`stage`), the flow at the new iterate and the engine's metrics
    there."""
    kept, out = flow.kept, {}
    for i, b in enumerate(judged):
        closure_flow = kept["closure_flows"][0][i]
        out[b] = {
            "flow": att.flow_init[b].float().cpu(),
            "closure_flows": [f[i].float().cpu()
                              for f in kept["closure_flows"]],
            "loss": float(torch.sqrt((closure_flow.double() ** 2).sum(-1))
                          .mean()),
            "grad": torch.cat([kept["g1"][i].flatten(),
                               kept["g2"][i].flatten()]).float().cpu(),
            "flow_step": flow_step[b].float().cpu(),
            "aee": float(aee[b]), "l2": float(l2[b]), **att.stage(b)}
    flow.kept = {}
    return out


def _judge(cfg, traffic, ref_module, path, images, answers,
           device) -> dict:
    """The numbers compared: the program's answers against the reference,
    on the same images and weight file, once the window is over."""
    if not answers:
        return dict.fromkeys(check.NUMBERS, float("inf"))
    common.plain_float32()
    net = check.reference_net(cfg, ref_module, path, device)
    return check.judge(cfg, traffic, net, *images, answers, device)


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    cell: cells.Cell
    run: dict

    def __getattr__(self, key):
        try:
            return self.run[key]
        except KeyError:
            raise AttributeError(key) from None


def _metrics(cell: cells.Cell, out: dict, trace: bool) -> dict:
    """{name: {value, unit}} of the cell's metrics whose readers find
    something to read."""
    ctx = Context(cell, out)
    got = {}
    for m in cell.metrics(trace):
        value = cells.module("metrics", m["name"], cell.root).read(ctx)
        if value is not None:
            got[m["name"]] = {"value": value, "unit": m["unit"]}
    return got


def step_summary(w: Window) -> dict:
    """Median and quartiles of the window's step times, in seconds."""
    ends = [w.start] + w.step_ends
    times = [b - a for a, b in zip(ends, ends[1:])]
    if len(times) < 2:
        return {"steps": len(times), "times_s": times}
    q = statistics.quantiles(times, n=4)
    return {"steps": len(times), "median_s": statistics.median(times),
            "q1_s": q[0], "q3_s": q[2], "first_s": times[0]}
