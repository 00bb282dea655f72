"""Static configuration shared with `pcfa_tpu/config.py` (same names, same
defaults): the dataset splits and roots (`PCFA_SINTEL_ROOT`,
`PCFA_KITTI15_ROOT`, then `pcfa_paths.json` in the working directory),
and the environment knobs `PCFA_LBFGS_DIRECTION`, `PCFA_LBFGS_DTYPE`
(with its refusal for PWCNet), `PCFA_COMPUTE_DTYPE`,
`PCFA_CORR_HBM_BUDGET_MB` and `PCFA_GRU_FUSED`.

`pcfa_tpu`'s `RuntimeConfig` (`PCFA_MATMUL_PRECISION`,
`PCFA_COMPILE_CACHE`) sets XLA's matmul precision and compile cache: the
port has no counterpart of either. Its float32 is always float32
(`_device.resolve_device` switches TF32 off) and it compiles nothing
per run but the kernels, built once per checkout.
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
