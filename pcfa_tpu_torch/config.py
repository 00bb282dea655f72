"""Environment knobs shared with `pcfa_tpu/config.py` (same names, same
defaults): `PCFA_LBFGS_DIRECTION`, `PCFA_LBFGS_DTYPE` (with its refusal
for PWCNet), `PCFA_COMPUTE_DTYPE` and `PCFA_CORR_HBM_BUDGET_MB`."""

from __future__ import annotations

import os
import warnings

import torch


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
