"""The yardstick's arithmetic: the FLOP count against a hand count, and
the kernels' bounds against `chip_smoke.py`'s at the same shapes."""

from __future__ import annotations

import json

import pytest
import torch
import torch.nn as nn

import flops
from conftest import BENCH
from kernels import corr_lookup, small_conv
from reference.common import Conv2d


class _ConvThenProduct(nn.Module):
    """One 3×3 conv 3 → 8 at 16×16, then a product with a 16×16 matrix."""

    def __init__(self):
        super().__init__()
        self.conv = Conv2d(3, 8, 3, padding=1)
        self.register_buffer("w", torch.ones(16, 16))

    def forward(self, a, b):
        y = self.conv((a + 0).permute(0, 3, 1, 2)) + b.sum()
        z = torch.matmul(y, self.w)                     # (1, 8, 16, 16)
        return z[:, :2].permute(0, 2, 3, 1)


def test_flops_of_one_conv_and_one_product():
    got = flops.per_pair(_ConvThenProduct, (16, 16), (16, 16), (0, 0, 0, 0))
    conv = 2 * (8 * 16 * 16) * 3 * 9
    product = 2 * (8 * 16) * 16 * 16
    assert got["forward"] == conv + product
    # the backward to the inputs: dx of the conv and d y of the product
    assert got["closure"] == 2 * (conv + product)


def _chip_smoke():
    return pytest.importorskip("chip_smoke")


def test_small_conv_bounds_match_chip_smoke_at_pwcnet():
    cs = _chip_smoke()
    calls = json.loads((BENCH / "configs/pwcnet-kitti-bf16.json")
                       .read_text())["kernel_calls"]["small_conv"]
    launches, fwd, dx = small_conv.per_forward_bound_s(calls, cs.PWC_PAIRS)
    want_fwd = want_dx = 0.0
    n = 0
    for layers, B, c_in, h, w, c_out, s in cs.PWC_CONVS:
        k, isz = 3, 2
        ho, wo = (h + 2 - k) // s + 1, (w + 2 - k) // s + 1
        out = B * c_out * ho * wo
        x, wt = B * c_in * h * w, c_out * c_in * k * k
        flop = 2 * out * c_in * k * k
        count = len(layers.split(","))
        n += count
        want_fwd += count * cs.bound_ms((x + wt + c_out + out) * isz, flop,
                                        torch.bfloat16)[0]
        want_dx += count * cs.bound_ms((2 * out + wt + x) * isz, flop,
                                       torch.bfloat16)[0]
    assert launches == n == 11
    assert fwd * 1e3 == pytest.approx(want_fwd, rel=1e-12)
    assert dx * 1e3 == pytest.approx(want_dx, rel=1e-12)
    # PERF.md's table: Σ11 bounds 0.0285 ms (forward), 0.0416 ms (dx)
    assert round(fwd * 1e3, 4) == 0.0285 and round(dx * 1e3, 4) == 0.0416


def test_lookup_cells_match_chip_smoke():
    cs = _chip_smoke()
    h, w, r = 47, 156, 4
    shapes = [(47, 156), (23, 78), (11, 39), (5, 19)]
    levels = [torch.zeros((1, a, b)) for a, b in shapes]
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    coords = torch.stack([xs, ys], -1).float().reshape(-1, 2)
    assert corr_lookup.patch_cells(h, w, 4, r) == cs.lookup_patch_cells(
        levels, coords, r)


def test_bounds_scale_with_the_launch_counts():
    cfg = json.loads((BENCH / "configs/raft-kitti-bf16.json").read_text())
    per, fwd, dx = small_conv.per_forward_bound_s(
        cfg["kernel_calls"]["small_conv"], 2)
    assert per == 10
    assert small_conv.bound_total_s(cfg, 2, {"fwd": 30, "dx": 20}) == \
        pytest.approx(3 * fwd + 2 * dx)
    assert small_conv.bound_total_s(cfg, 2, {"fwd": 31, "dx": 20}) is None
    f, b = corr_lookup.launch_bounds_s(cfg["kernel_calls"]["corr_lookup"], 2)
    assert corr_lookup.bound_total_s(cfg, 2, {"fwd": 24, "bwd": 12}) == \
        pytest.approx(24 * f + 12 * b)
