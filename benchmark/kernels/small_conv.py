"""The small-channel convolution (`ops/small_conv.py` → `csrc/small_conv.cu`):
the names its kernels carry in a device trace, the program's launch
counters, and its bytes and operations from the shapes of a
configuration's `kernel_calls['small_conv']`.

A forward reads x, the weights and the bias and writes the output: 2 ·
output elements · C_in · k² operations. dx reads the cotangent (twice
where an activation's derivative is applied, which needs the forward's
output too), the weights and x's shape, and writes dx: the same
operations."""

from __future__ import annotations

from roofline import bound_s

NAMES = ("conv_tc_kernel", "conv_fwd_f32", "conv_dx_f32")
COUNTERS = {"fwd": ("pcfa_tpu_torch.ops.small_conv", "small_conv_fwd"),
            "dx": ("pcfa_tpu_torch.ops.small_conv", "small_conv_dx")}


def matches(name: str) -> bool:
    return any(n in name for n in NAMES)


def _out(n: int, k: int, stride: int) -> int:
    return (n + 2 * (k // 2) - k) // stride + 1


def per_forward_bound_s(calls: dict, pairs: int) -> tuple[int, float, float]:
    """(launches, forward bound, dx bound) of one forward's calls."""
    isz = calls["dtype_bytes"]
    launches, fwd, dx = 0, 0.0, 0.0
    dtype = "bfloat16" if isz == 2 else "float32"
    for c in calls["per_forward"]:
        b = c["images"] * pairs
        x = b * c["c_in"] * c["h"] * c["w"]
        out = b * c["c_out"] * _out(c["h"], c["k"], c["stride"]) * _out(
            c["w"], c["k"], c["stride"])
        w = c["c_out"] * c["c_in"] * c["k"] ** 2
        flops = 2 * out * c["c_in"] * c["k"] ** 2
        g_reads = 2 if c["act"] else 1
        fwd += c["count"] * bound_s((x + w + c["c_out"] + out) * isz, flops,
                                    dtype)
        dx += c["count"] * bound_s((g_reads * out + w + x) * isz, flops,
                                   dtype)
        launches += c["count"]
    return launches, fwd, dx


def bound_total_s(config: dict, pairs: int, launches: dict) -> float | None:
    """Σ bound of the launches counted, or None where the counts are not
    whole forwards of the configuration's calls."""
    calls = config.get("kernel_calls", {}).get("small_conv")
    if calls is None:
        return None
    per, fwd, dx = per_forward_bound_s(calls, pairs)
    n_fwd, n_dx = launches.get("fwd", 0), launches.get("dx", 0)
    if n_fwd == 0 or n_fwd % per or n_dx % per:
        return None
    return n_fwd // per * fwd + n_dx // per * dx
