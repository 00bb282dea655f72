"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity, at the full 700 W) and the least time a piece of work
can take on it: the larger of its bytes over the memory bandwidth and
its operations over the peak rate. Each input byte is counted read once
and each output byte written once, whatever a kernel reads again."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
