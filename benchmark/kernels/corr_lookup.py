"""The correlation window lookup (`ops/corr_lookup.py` →
`csrc/corr_lookup.cu`): trace names, the program's launch counters, and
bytes and operations from a configuration's `kernel_calls['corr_lookup']`.

Every query reads the in-map cells of its (2r+2)² patch on each level and
writes L·(2r+1)² values (3·3 operations each: weights and blend); the
backward reads the cotangent and adds into the same cells (read and
write: 12 operations each). The patches are counted for queries at their
own pixel (zero flow), from the shapes alone."""

from __future__ import annotations

import numpy as np

from roofline import bound_s

NAMES = ("corr_window_fwd_kernel", "corr_window_bwd_kernel")
COUNTERS = {"fwd": ("pcfa_tpu_torch.ops.corr_lookup", "corr_window_fwd"),
            "bwd": ("pcfa_tpu_torch.ops.corr_lookup", "corr_window_bwd")}


def matches(name: str) -> bool:
    return any(n in name for n in NAMES)


def patch_cells(h: int, w: int, levels: int, r: int) -> int:
    """In-map cells of every query's (2r+2)² patch over all levels, for
    queries at the pixels of an h × w map (level i: the map pooled i
    times, 2× each, rounding down)."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    total, lh, lw, side = 0, h, w, 2 * r + 2
    for i in range(levels):
        x0 = np.floor(xs / 2 ** i) - r
        y0 = np.floor(ys / 2 ** i) - r
        nx = np.clip(np.minimum(x0 + side, lw) - np.maximum(x0, 0), 0, None)
        ny = np.clip(np.minimum(y0 + side, lh) - np.maximum(y0, 0), 0, None)
        total += int((nx * ny).sum())
        lh, lw = lh // 2, lw // 2
    return total


def launch_bounds_s(calls: dict, pairs: int) -> tuple[float, float]:
    """(forward, backward) bound of one launch."""
    c, isz = calls["per_forward"], calls["dtype_bytes"]
    b = c["images"] * pairs
    n = b * c["h"] * c["w"]
    cells = b * patch_cells(c["h"], c["w"], c["levels"], c["radius"])
    out = n * c["levels"] * (2 * c["radius"] + 1) ** 2
    dtype = "bfloat16" if isz == 2 else "float32"
    fwd = bound_s(cells * isz + n * 2 * 4 + out * isz, 9 * out, dtype)
    bwd = bound_s(out * isz + n * 2 * 4 + 2 * cells * isz, 12 * cells, dtype)
    return fwd, bwd


def bound_total_s(config: dict, pairs: int, launches: dict) -> float | None:
    calls = config.get("kernel_calls", {}).get("corr_lookup")
    if calls is None or not launches.get("fwd"):
        return None
    fwd, bwd = launch_bounds_s(calls, pairs)
    return launches["fwd"] * fwd + launches.get("bwd", 0) * bwd
