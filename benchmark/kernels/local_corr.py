"""The patch correlation (`ops/local_corr.py` → `csrc/local_corr.cu`):
the names its kernels carry in a device trace, the program's launch
counters, and bytes and operations from a configuration's
`kernel_calls['local_corr']`.

A forward reads f1 and f2 and writes the patch² correlations of every
pixel: 2 operations for each (pixel, shift, channel) product whose
shifted pixel lies in the map (zero padding needs none). The backward
reads the cotangent, f1 and f2 and writes df1 and df2: twice the
forward's operations."""

from __future__ import annotations

from roofline import bound_s

NAMES = ("corr_fwd_kernel", "corr_bwd_kernel")
COUNTERS = {"fwd": ("pcfa_tpu_torch.ops.local_corr", "local_corr_fwd"),
            "bwd": ("pcfa_tpu_torch.ops.local_corr", "local_corr_bwd")}


def matches(name: str) -> bool:
    return any(n in name for n in NAMES)


def valid_products(h: int, w: int, patch: int, stride: int) -> int:
    """(pixel, shift) pairs of an h × w map whose shifted pixel lies in
    the map."""
    r = (patch - 1) // 2 * stride
    offs = [i * stride - r for i in range(patch)]
    return (sum(max(0, h - abs(d)) for d in offs)
            * sum(max(0, w - abs(d)) for d in offs))


def per_forward_bound_s(calls: dict, pairs: int) -> tuple[int, float, float]:
    """(launches, forward bound, backward bound) of one forward's
    correlations."""
    isz, patch, stride = calls["dtype_bytes"], calls["patch"], calls["stride"]
    dtype = "bfloat16" if isz == 2 else "float32"
    launches, fwd, bwd = 0, 0.0, 0.0
    for c in calls["per_forward"]:
        b = c["images"] * pairs
        fmap = b * c["h"] * c["w"] * c["c"]
        out = b * c["h"] * c["w"] * patch * patch
        prods = b * valid_products(c["h"], c["w"], patch, stride) * c["c"]
        fwd += bound_s((2 * fmap + out) * isz, 2 * prods, dtype)
        bwd += bound_s((out + 4 * fmap) * isz, 4 * prods, dtype)
        launches += 1
    return launches, fwd, bwd


def bound_total_s(config: dict, pairs: int, launches: dict) -> float | None:
    """Σ bound of the launches counted, or None where the counts are not
    whole forwards of the configuration's calls."""
    calls = config.get("kernel_calls", {}).get("local_corr")
    if calls is None:
        return None
    per, fwd, bwd = per_forward_bound_s(calls, pairs)
    n_fwd, n_bwd = launches.get("fwd", 0), launches.get("bwd", 0)
    if n_fwd == 0 or n_fwd % per or n_bwd % per:
        return None
    return n_fwd // per * fwd + n_bwd // per * bwd
