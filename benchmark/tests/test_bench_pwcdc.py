"""The PWC-DC cell's yardstick: the patch correlation's and the warp
backward's bounds against `chip_smoke.py`'s at PWCNet's shapes, their
readers' refusal of a trace whose launches differ from the counters, and
the cell as `BENCHMARK.json` declares it."""

from __future__ import annotations

import json

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

import cells
import harness
import timeline
from conftest import BENCH, benchmark_json, tiny_cell
from kernels import local_corr, warp_bwd
from standin import StandIn

CELL = "pwcnet-pcfa-kitti-b1"
CONFIG = "pwcdc-kitti-bf16"


def _chip_smoke():
    return pytest.importorskip("chip_smoke")


def _calls(kernel: str) -> dict:
    return json.loads((BENCH / f"configs/{CONFIG}.json").read_text())[
        "kernel_calls"][kernel]


def test_local_corr_bounds_match_chip_smoke_at_pwcnet():
    cs = _chip_smoke()
    launches, fwd, bwd = local_corr.per_forward_bound_s(
        _calls("local_corr"), cs.PWC_PAIRS)
    want_fwd = want_bwd = 0.0
    for _, h, w, c in cs.PWC_LEVELS:
        isz, b = 2, cs.PWC_PAIRS
        fmap, out = b * h * w * c, b * h * w * 81
        prods = b * cs.valid_products(h, w, 9, 1) * c
        want_fwd += cs.bound_ms((2 * fmap + out) * isz, 2 * prods,
                                torch.bfloat16)[0]
        want_bwd += cs.bound_ms((out + 4 * fmap) * isz, 4 * prods,
                                torch.bfloat16)[0]
    assert launches == len(cs.PWC_LEVELS) == 5
    assert fwd * 1e3 == pytest.approx(want_fwd, rel=1e-12)
    assert bwd * 1e3 == pytest.approx(want_bwd, rel=1e-12)
    # PERF.md's kernel table: Σ5 bounds 0.0041 ms (forward), 0.0061 (bwd)
    assert round(fwd * 1e3, 4) == 0.0041 and round(bwd * 1e3, 4) == 0.0061


def test_warp_bwd_bounds_match_chip_smoke_at_pwcnet():
    """`kernels_warp_bwd`'s bytes: the saved state's tensors as
    `warp_state` makes them (meta tensors of the same shapes and dtypes),
    d img in the image's dtype, d ix and d iy in float32."""
    cs = _chip_smoke()
    launches, bound = warp_bwd.per_forward_bound_s(_calls("warp_bwd"),
                                                   cs.PWC_PAIRS)
    want = 0.0
    for _, h, w, c in cs.PWC_LEVELS[1:]:
        b, dtype = cs.PWC_PAIRS, torch.bfloat16
        n = b * h * w

        def meta(shape, dt):
            return torch.empty(shape, dtype=dt, device="meta")

        state = [meta((b, h, w, c), torch.float32), meta((n, 4, c), dtype),
                 meta((n,), torch.int64), meta((n, 4), torch.float32),
                 meta((n, 4), torch.bool), meta((b, h, w), torch.float32),
                 meta((b, h, w), torch.float32)]
        nbytes = (sum(t.numel() * t.element_size() for t in state)
                  + b * h * w * c * 2 + 2 * n * 4)
        want += cs.bound_ms(nbytes, 16 * n * c, dtype)[0]
    assert launches == len(cs.PWC_LEVELS) - 1 == 4
    assert bound * 1e3 == pytest.approx(want, rel=1e-12)
    # PERF.md's kernel table: Σ4 bound 0.0077 ms
    assert round(bound * 1e3, 4) == 0.0077


def test_bounds_scale_with_the_launch_counts():
    cfg = json.loads((BENCH / f"configs/{CONFIG}.json").read_text())
    _, fwd, bwd = local_corr.per_forward_bound_s(cfg["kernel_calls"][
        "local_corr"], 1)
    assert local_corr.bound_total_s(cfg, 1, {"fwd": 15, "bwd": 10}) == \
        pytest.approx(3 * fwd + 2 * bwd)
    assert local_corr.bound_total_s(cfg, 1, {"fwd": 16, "bwd": 10}) is None
    _, warp = warp_bwd.per_forward_bound_s(cfg["kernel_calls"]["warp_bwd"], 1)
    assert warp_bwd.bound_total_s(cfg, 1, {"bwd": 8}) == \
        pytest.approx(2 * warp)
    assert warp_bwd.bound_total_s(cfg, 1, {"bwd": 9}) is None
    assert warp_bwd.bound_total_s({}, 1, {"bwd": 8}) is None


def _timeline(names: list[str]):
    """A stand-in timeline of a CPU slice whose first device operations
    carry `names` (as a kernel's trace name would), the rest the stand-in's
    own."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.slice"):
            x = torch.ones(8)
            for _ in range(len(names) + 3):
                x = x + 1
    standin = StandIn(prof)
    device = [e for e in standin._events if e.device_type()
              == DeviceType.CUDA]
    assert len(device) >= len(names)
    for e, name in zip(device, names):
        e._v = (name, *e._v[1:])
    return timeline.read(standin, [])


@pytest.mark.parametrize("metric,kernel,counters,names", [
    ("local_corr_roofline", "local_corr", {"fwd": 5, "bwd": 5},
     ["void corr_fwd_kernel<__nv_bfloat16>(Args)"] * 5
     + ["void corr_bwd_kernel<__nv_bfloat16>(Args)"] * 5),
    ("warp_bwd_roofline", "warp_bwd", {"bwd": 4},
     ["void (anonymous namespace)::warp_bwd_kernel<unsigned short, 4>()"]
     * 4),
])
def test_readers_read_only_a_trace_that_holds_every_counted_launch(
        metric, kernel, counters, names):
    cell = cells.load(benchmark_json(), CELL)
    reader = cells.module("metrics", metric)

    def read(tl, launches):
        w = harness.Window(launches={kernel: launches})
        return reader.read(harness.Context(cell, {
            "timeline": tl, "window": w, "config": cell.config, "pairs": 1}))

    tl = _timeline(names)
    got = read(tl, counters)
    assert got is not None and got > 0
    # one launch fewer in the trace than counted, or one more counted
    assert read(_timeline(names[1:]), counters) is None
    more = dict(counters, bwd=counters["bwd"] + 1)
    assert read(tl, more) is None
    # no kernel launched and none counted: nothing to read
    assert read(_timeline([]), dict.fromkeys(counters, 0)) is None
    assert read(None, counters) is None


def test_the_cell_loads_its_benchmark_entry():
    bench = benchmark_json()
    entry = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert entry["config"] == CONFIG and entry["chips"] == 1
    cell = tiny_cell(CELL)
    assert cell.config["name"] == CONFIG
    assert set(cell.config["kernel_calls"]) == {"small_conv", "local_corr",
                                                "warp_bwd"}
    assert cell.traffic["attack"] == "pcfa"
    reported = {m["name"] for m in cell.per_layer}
    assert {"local_corr_roofline", "warp_bwd_roofline", "lbfgs_ms",
            "network_ms", "launches_per_closure", "small_conv_roofline",
            "device_idle_pct", "mfu_pct"} == reported
    assert "pairs_per_s.device_bound" not in {m["name"]
                                              for m in cell.end_to_end}
    for kernel in cell.config["kernel_calls"]:
        mod = cells.module("kernels", kernel)
        for module, attr in mod.COUNTERS.values():
            assert hasattr(__import__(module, fromlist=[attr]), attr)
    # the configuration is the old PWCNet file's, bar its name and the two
    # kernels' shapes
    old = json.loads((BENCH / "configs/pwcnet-kitti-bf16.json").read_text())
    new = json.loads((BENCH / f"configs/{CONFIG}.json").read_text())
    same = set(old) - {"name", "kernel_calls", "limits"}
    assert {k: old[k] for k in same} == {k: new[k] for k in same}
    assert new["kernel_calls"]["small_conv"] == \
        old["kernel_calls"]["small_conv"]
