"""Attack targets (`pcfa_tpu/attack/targets.py`): zero flow, negated flow,
and the crop/reflect-pad fit of a custom (H, W, 2) target. Reading a
custom target file needs the flow-file IO, which is a later slice."""

from __future__ import annotations

import numpy as np
import torch


def zero_flow(flow: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(flow)


def neg_flow(flow: torch.Tensor) -> torch.Tensor:
    return -flow


def fit_custom_target(target: np.ndarray, height: int,
                      width: int) -> np.ndarray:
    """Crop or reflect-pad (right/bottom) a (H, W, 2) target to
    (height, width)."""
    if width < target.shape[1]:
        target = target[:, :width, :]
    elif width > target.shape[1]:
        target = np.pad(target, ((0, 0), (0, width - target.shape[1]),
                                 (0, 0)), mode="reflect")
    if height < target.shape[0]:
        target = target[:height, :, :]
    elif height > target.shape[0]:
        target = np.pad(target, ((0, height - target.shape[0]), (0, 0),
                                 (0, 0)), mode="reflect")
    return target


def make_target_fn(target_name: str):
    """flow_pred_init (..., H, W, 2) → target."""
    if target_name == "zero":
        return zero_flow
    if target_name == "neg_flow":
        return neg_flow
    if target_name == "custom":
        raise NotImplementedError(
            "custom targets need the flow-file IO (io/flow_io.py), which is "
            "not ported yet")
    raise ValueError(
        f'The specified target type "{target_name}" is not defined and '
        'cannot be used. Select one of "zero", "neg_flow" or "custom".')
