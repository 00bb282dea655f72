"""NaN-aware flow error measures: AAE, pixelwise EE, AEE, BP, Fl.

The port's own copy of `pcfa_tpu/metrics/flow_errors.py` (numpy).

Numerics-compatible rebuild of `flow_library/flow_errors.py`. All functions
take flow fields of shape (H, W, 2) with NaN marking pixels without ground
truth, and reduce over the valid pixels only.
"""

from __future__ import annotations

import numpy as np


def compute_AAE(flow: np.ndarray, gt: np.ndarray) -> float:
    """Average angular error in degrees (`flow_errors.py:4-26`)."""
    arg = flow[:, :, 0] * gt[:, :, 0] + flow[:, :, 1] * gt[:, :, 1] + 1.0
    count = np.count_nonzero(~np.isnan(arg))
    arg = arg / (
        np.sqrt(flow[:, :, 0] ** 2 + flow[:, :, 1] ** 2 + 1)
        * np.sqrt(gt[:, :, 0] ** 2 + gt[:, :, 1] ** 2 + 1)
    )
    arg = np.nan_to_num(arg, nan=1.0)  # arccos(1) = 0 for invalid pixels
    arg = np.clip(arg, -1.0, 1.0)
    return float(np.sum(np.arccos(arg)) / count / (2 * np.pi) * 360.0)


def compute_EE(flow: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Pixelwise endpoint error, NaN where no ground truth (`flow_errors.py:29-39`)."""
    return np.sqrt(np.sum(np.square(flow - gt), axis=-1))


def compute_AEE(flow: np.ndarray, gt: np.ndarray, ee: np.ndarray | None = None) -> float:
    """Average endpoint error over valid pixels (`flow_errors.py:42-51`)."""
    if ee is None:
        ee = compute_EE(flow, gt)
    count = np.count_nonzero(~np.isnan(ee))
    return float(np.nansum(ee) / count)


def compute_BP(
    flow: np.ndarray,
    gt: np.ndarray,
    use_kitti15: bool = False,
    ee: np.ndarray | None = None,
) -> float:
    """Bad-pixel percentage: EE > 3px, optionally AND > 5% of the ground-truth
    vector length (KITTI15 rule). Returns a percentage in [0, 100]
    (`flow_errors.py:54-85`)."""
    if ee is None:
        ee = compute_EE(flow, gt)
    count = np.count_nonzero(~np.isnan(ee))
    ee = np.nan_to_num(ee, nan=0.0)
    abs_err = ee > 3.0
    if use_kitti15:
        gt_len = np.nan_to_num(
            np.sqrt(np.square(gt[..., 0]) + np.square(gt[..., 1])), nan=0.0
        )
        bp_mask = abs_err & (ee > 0.05 * gt_len)
    else:
        bp_mask = abs_err
    return float(100.0 * np.sum(bp_mask) / count)


def compute_Fl(flow: np.ndarray, gt: np.ndarray, ee: np.ndarray | None = None) -> float:
    """KITTI Fl measure = BP with the KITTI15 rule (`flow_errors.py:88-97`)."""
    return compute_BP(flow, gt, use_kitti15=True, ee=ee)


def get_all_error_measures(flow: np.ndarray, gt: np.ndarray) -> dict:
    """Dict with AAE, AEE, BP, Fl (`flow_errors.py:109-122`)."""
    result = {"AAE": compute_AAE(flow, gt)}
    ee = compute_EE(flow, gt)
    result["AEE"] = compute_AEE(flow, gt, ee=ee)
    result["BP"] = compute_BP(flow, gt, ee=ee)
    result["Fl"] = compute_Fl(flow, gt, ee=ee)
    return result


def get_all_error_measures_area(flow: np.ndarray, gt: np.ndarray, area: np.ndarray) -> dict:
    """Error measures restricted to a boolean pixel mask (`flow_errors.py:125-134`)."""
    gt_area = gt.copy()
    gt_area[~area] = np.nan
    return get_all_error_measures(flow, gt_area)
