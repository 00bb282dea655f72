"""The warp's backward (`ops/segsum.py` → `csrc/segsum.cu`): the names
its kernels carry in a device trace, the program's launch counter, and
bytes and operations from a configuration's `kernel_calls['warp_bwd']`.

A launch is the packed sampler's whole backward for one warp of
`images` maps of h × w × c, one sample per pixel: it reads the float32
cotangent, the saved 2×2 corner windows (the image's dtype), the window
index (int64), the four float32 weights, the zeros mode's corner mask
(one byte each) and the two float32 fractions, and writes d img (the
image's dtype) and d ix, d iy (float32); 16 operations per sample and
channel (four dots, four scaled adds)."""

from __future__ import annotations

from roofline import bound_s

NAMES = ("warp_bwd_kernel", "warp_bwd_narrow_kernel")
COUNTERS = {"bwd": ("pcfa_tpu_torch.ops.segsum", "warp_bwd_cuda")}


def matches(name: str) -> bool:
    return any(n in name for n in NAMES)


def launch_bytes(n: int, c: int, isz: int, zeros: bool) -> int:
    """Bytes one launch reads and writes for n samples of c channels."""
    reads = n * c * 4 + n * 4 * c * isz + n * 8 + n * 4 * 4 + 2 * n * 4
    mask = n * 4 if zeros else 0
    return reads + mask + n * c * isz + 2 * n * 4


def per_forward_bound_s(calls: dict, pairs: int) -> tuple[int, float]:
    """(launches, bound) of one forward's warps."""
    isz, zeros = calls["image_bytes"], calls["mode"] == "zeros"
    dtype = "bfloat16" if isz == 2 else "float32"
    launches, total = 0, 0.0
    for c in calls["per_forward"]:
        n = c["images"] * pairs * c["h"] * c["w"]
        total += bound_s(launch_bytes(n, c["c"], isz, zeros),
                         16 * n * c["c"], dtype)
        launches += 1
    return launches, total


def bound_total_s(config: dict, pairs: int, launches: dict) -> float | None:
    """Σ bound of the launches counted, or None where the count is not a
    whole number of forwards' warps."""
    calls = config.get("kernel_calls", {}).get("warp_bwd")
    if calls is None:
        return None
    per, bound = per_forward_bound_s(calls, pairs)
    n = launches.get("bwd", 0)
    if n == 0 or n % per:
        return None
    return n // per * bound
