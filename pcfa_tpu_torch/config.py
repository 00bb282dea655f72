"""Static configuration shared with `pcfa_tpu/config.py` (same names, same
defaults): the dataset splits and roots (`PCFA_SINTEL_ROOT`,
`PCFA_KITTI15_ROOT`, then `pcfa_paths.json` in the working directory),
the environment knobs `PCFA_LBFGS_DIRECTION`, `PCFA_LBFGS_DTYPE` (with its
refusal for PWCNet), `PCFA_COMPUTE_DTYPE`, `PCFA_CORR_HBM_BUDGET_MB` and
`PCFA_GRU_FUSED`, and `RuntimeConfig` (`PCFA_MATMUL_PRECISION`).

`pcfa_tpu`'s `PCFA_COMPILE_CACHE` has no counterpart: the port traces and
compiles nothing per run. Its only compiled code is the CUDA kernels,
built once per checkout (`ops/_build.py`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from pathlib import Path

import torch

_PATHS_FILE = "pcfa_paths.json"

# Dataset split names
SPLITS = {
    "sintel_train": "training",
    "sintel_eval": "test",
    "kitti_train": "training",
    "kitti_eval": "testing",
}


@dataclasses.dataclass(frozen=True)
class PathsConfig:
    """Dataset roots. Empty string means 'not configured'."""

    sintel_mpi: str = ""
    kitti15: str = ""

    @staticmethod
    def load(cwd: str | None = None) -> "PathsConfig":
        cfg = {}
        path = Path(cwd or os.getcwd()) / _PATHS_FILE
        if path.is_file():
            try:
                cfg = json.loads(path.read_text())
            except (OSError, json.JSONDecodeError):
                cfg = {}
        return PathsConfig(
            sintel_mpi=os.environ.get("PCFA_SINTEL_ROOT",
                                      cfg.get("sintel_mpi", "")),
            kitti15=os.environ.get("PCFA_KITTI15_ROOT",
                                   cfg.get("kitti15", "")),
        )


def splits(name: str) -> str:
    return SPLITS[name]


def paths(name: str) -> str:
    return getattr(PathsConfig.load(), name)


def lbfgs_direction() -> str:
    """'compact' (Byrd–Nocedal–Schnabel form, the default) or 'two_loop'."""
    return os.environ.get("PCFA_LBFGS_DIRECTION", "compact")


def lbfgs_history_dtype(net: str | None = None) -> str | None:
    """Curvature-pair storage dtype ('bfloat16') or None for float32.

    A bf16 history destabilizes PWCNet's attack trajectory, so PWCNet with
    bfloat16 raises unless PCFA_LBFGS_DTYPE_FORCE=1 (then it warns)."""
    v = os.environ.get("PCFA_LBFGS_DTYPE", "")
    v = v if v and v != "float32" else None
    if v == "bfloat16" and net == "PWCNet":
        if os.environ.get("PCFA_LBFGS_DTYPE_FORCE") == "1":
            warnings.warn(
                "PCFA_LBFGS_DTYPE=bfloat16 with PWCNet destabilizes the "
                "attack trajectory; forcing because "
                "PCFA_LBFGS_DTYPE_FORCE=1", stacklevel=2)
            return v
        raise ValueError(
            "PCFA_LBFGS_DTYPE=bfloat16 is unsupported for PWCNet: a bf16 "
            "curvature history destabilizes its attack trajectory. Unset "
            "PCFA_LBFGS_DTYPE or set PCFA_LBFGS_DTYPE_FORCE=1 to override "
            "for experiments.")
    return v


def compute_dtype() -> torch.dtype | None:
    """PCFA_COMPUTE_DTYPE as a torch dtype; None (float32) when unset."""
    name = os.environ.get("PCFA_COMPUTE_DTYPE", "")
    if name in ("", "float32"):
        return None
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"PCFA_COMPUTE_DTYPE={name!r} is not a float dtype")
    return dt


def corr_hbm_budget_bytes() -> int:
    """Device-memory budget of the materialized corr pyramid (default
    6 GiB, PCFA_CORR_HBM_BUDGET_MB)."""
    return int(os.environ.get("PCFA_CORR_HBM_BUDGET_MB", "6144")) << 20


def gru_fused() -> bool:
    """PCFA_GRU_FUSED=1: the SepConvGRU's z and r gates as one conv."""
    return os.environ.get("PCFA_GRU_FUSED", "0") == "1"


MATMUL_PRECISIONS = ("highest", "high", "default")

#: the RuntimeConfig last applied in this process (None: none yet)
_applied: "RuntimeConfig | None" = None


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Precision and debugging switches of a run (`pcfa_tpu`'s
    `RuntimeConfig`). `PCFA_MATMUL_PRECISION`, when set, overrides
    `matmul_precision`. On an H100:

    * 'highest' (the default): float32 matrix products and cuDNN
      convolutions in full float32 (TF32 off). Every float32 parity check
      runs under it.
    * 'high' and 'default': float32 products and cuDNN convolutions on
      the TF32 tensor cores (inputs rounded to a 10-bit mantissa, float32
      accumulation), at up to ~7× the CUDA cores' float32 rate (published
      dense peaks, 495 against 67 TFLOP/s); products keep about 3
      decimal digits. The JAX package's
      'default' is a bf16 pass on a TPU; the port takes TF32 for both,
      which cuDNN's convolutions also offer. bf16 networks
      (`PCFA_COMPUTE_DTYPE`) are not affected by either.

    `debug_nans` switches on `torch.autograd.set_detect_anomaly`: a
    backward that makes a NaN raises at the operation that made it, as
    `jax_debug_nans` does (it slows every backward)."""

    matmul_precision: str = "highest"
    debug_nans: bool = False

    def apply(self) -> None:
        global _applied
        p = os.environ.get("PCFA_MATMUL_PRECISION", self.matmul_precision)
        if p not in MATMUL_PRECISIONS:
            raise ValueError(f"matmul precision {p!r}: expected one of "
                             f"{MATMUL_PRECISIONS}")
        tf32 = p != "highest"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        torch.autograd.set_detect_anomaly(self.debug_nans)
        _applied = self


def ensure_runtime_config() -> None:
    """Apply the default `RuntimeConfig()` unless one was applied in this
    process already: an entry point called without the CLIs' set-up still
    runs float32 as float32 ('highest', or `PCFA_MATMUL_PRECISION`)."""
    if _applied is None:
        RuntimeConfig().apply()
