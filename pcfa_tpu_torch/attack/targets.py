"""Attack targets (`pcfa_tpu/attack/targets.py`): zero flow, negated flow,
and a custom (H, W, 2) flow read from a file on the host and fitted
(right/bottom crop or reflect-pad) to the prediction's size."""

from __future__ import annotations

import numpy as np
import torch

from pcfa_tpu_torch.io.flow_io import read_gen


def zero_flow(flow: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(flow)


def neg_flow(flow: torch.Tensor) -> torch.Tensor:
    return -flow


def load_custom_target(path_to_custom_target: str) -> np.ndarray:
    """A custom target flow file (.npy, .flo, .pfm, ... by the generic
    reader) as (H, W, 2) float32; channels-first (2, H, W) artifacts and a
    leading batch axis of one are accepted."""
    data = read_gen(path_to_custom_target)
    if data is None or len(np.shape(data)) < 2:
        raise ValueError(
            f"The specified custom target file is not a valid flow file at "
            f"{path_to_custom_target}. Please specify a valid flow file via "
            f"--custom_target_path")
    data = np.array(data).astype(np.float32)
    if data.ndim == 4:
        data = data[0]
    if data.ndim == 3 and data.shape[0] == 2 and data.shape[-1] != 2:
        data = np.transpose(data, (1, 2, 0))
    if data.ndim != 3 or data.shape[-1] != 2:
        raise ValueError(f"Custom target at {path_to_custom_target} has "
                         f"invalid shape {data.shape}")
    return data


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


def make_target_fn(target_name: str, custom_target_path: str = ""):
    """flow_pred_init (..., H, W, 2) → target. For 'custom' the file is
    read once, here; the fitted target is broadcast over the leading axes
    on the flow's device, in its dtype."""
    if target_name == "zero":
        return zero_flow
    if target_name == "neg_flow":
        return neg_flow
    if target_name == "custom":
        data = load_custom_target(custom_target_path)

        def custom(flow: torch.Tensor) -> torch.Tensor:
            fitted = fit_custom_target(data, flow.shape[-3], flow.shape[-2])
            tgt = torch.from_numpy(np.ascontiguousarray(fitted)).to(
                device=flow.device, dtype=flow.dtype)
            return tgt.expand(flow.shape).clone()

        return custom
    raise ValueError(
        f'The specified target type "{target_name}" is not defined and '
        'cannot be used. Select one of "zero", "neg_flow" or "custom".')
