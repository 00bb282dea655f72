"""Flow visualization: Middlebury-colorwheel and HSV color coding, error maps.

The port's own copy of `pcfa_tpu/viz/flow_plot.py` (numpy; matplotlib
imported only by `colorplot_dark`).

Output-compatible rebuild of `flow_library/flow_plot.py` (vectorized — the
per-channel colorwheel interpolation loop is replaced by one fancy-indexing
pass). All functions take (H, W, 2) flow and return uint8 (H, W, 3) RGB.
"""

from __future__ import annotations

import numpy as np


def middlebury_colorwheel() -> np.ndarray:
    """55-entry Middlebury color wheel (Baker et al., ICCV 2007), matching
    `flow_plot.py:157-203`."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


def colorplot_light(
    flow: np.ndarray,
    auto_scale: bool = True,
    max_scale: float = -1,
    return_max: bool = False,
):
    """Middlebury colorwheel coding on white background (`flow_plot.py:56-105`)."""
    assert flow.ndim == 3 and flow.shape[2] == 2, "flow must have shape (H, W, 2)"
    flow = np.array(flow, dtype=np.float64, copy=True)
    nan = np.isnan(flow[:, :, 0]) | np.isnan(flow[:, :, 1])
    flow[nan, :] = 0

    u, v = flow[:, :, 0], flow[:, :, 1]
    rad = np.sqrt(u**2 + v**2)
    if auto_scale:
        max_scale = rad.max()
    eps = 1e-5
    u = u / (max_scale + eps)
    v = v / (max_scale + eps)

    wheel = middlebury_colorwheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = k0 + 1
    k1[k1 == ncols] = 0
    f = (fk - k0)[..., None]

    col = (1 - f) * wheel[k0] / 255.0 + f * wheel[k1] / 255.0
    in_range = (rad <= 1)[..., None]
    col = np.where(in_range, 1 - rad[..., None] * (1 - col), col * 0.75)
    img = np.floor(255 * col).astype(np.uint8)
    img[nan, :] = 0
    if return_max:
        return img, max_scale
    return img


def colorplot_dark(
    flow: np.ndarray,
    auto_scale: bool = True,
    max_scale: float = -1,
    transform: str | None = None,
    return_max: bool = False,
):
    """HSV coding on black background with optional log transforms
    (`flow_plot.py:6-53`)."""
    import matplotlib.colors

    flow = np.array(flow, dtype=np.float64, copy=True)
    nan = np.isnan(flow[:, :, 0]) | np.isnan(flow[:, :, 1])
    flow[nan, :] = 0

    mag = np.sqrt(flow[:, :, 0] ** 2 + flow[:, :, 1] ** 2)
    if auto_scale:
        max_scale = mag.max()

    hue = -np.arctan2(flow[:, :, 1], flow[:, :, 0]) % (2 * np.pi) / (2 * np.pi) * 360
    lo = hue < 90
    mid = (hue < 180) & (hue >= 90)
    hi = hue >= 180
    hue[lo] *= 60 / 90
    hue[mid] = (hue[mid] - 90) * 60 / 90 + 60
    hue[hi] = (hue[hi] - 180) * 240 / 180 + 120
    hue /= 360

    if transform is None:
        value = mag / float(max_scale)
    elif transform == "log":
        value = np.log10(9 * mag / float(max_scale) + 1)
    elif transform == "loglog":
        value = np.log10(9 * np.log10(9 * mag / float(max_scale) + 1) + 1)
    else:
        raise ValueError("wrong value for parameter transform")
    value = np.minimum(value, 1.0)

    hsv = np.stack((hue, np.ones_like(hue), value), axis=-1)
    rgb = (matplotlib.colors.hsv_to_rgb(hsv) * 255).astype(np.uint8)
    rgb[nan, :] = 0
    if return_max:
        return rgb, max_scale
    return rgb


_ERROR_COLORS = [
    (0.1875, [49, 53, 148]),
    (0.375, [69, 116, 180]),
    (0.75, [115, 173, 209]),
    (1.5, [171, 216, 233]),
    (3, [223, 242, 248]),
    (6, [254, 223, 144]),
    (12, [253, 173, 96]),
    (24, [243, 108, 67]),
    (48, [215, 48, 38]),
    (np.inf, [165, 0, 38]),
]


def errorplot(flow: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """KITTI-style logarithmic error map (`flow_plot.py:108-134`)."""
    from pcfa_tpu_torch.metrics.flow_errors import compute_EE

    ee = compute_EE(flow, gt)
    nan = np.isnan(ee)
    ee = np.nan_to_num(ee)
    result = np.zeros(ee.shape + (3,), dtype=np.uint8)
    for threshold, color in reversed(_ERROR_COLORS):
        result[ee < threshold, :] = color
    result[nan, :] = [0, 0, 0]
    return result


def errorplot_Fl(flow: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Binary Fl bad-pixel map: red=bad, green=good (`flow_plot.py:137-154`)."""
    from pcfa_tpu_torch.metrics.flow_errors import compute_EE

    ee = compute_EE(flow, gt)
    nan = np.isnan(ee)
    ee = np.nan_to_num(ee)
    gt_len = np.sqrt(np.square(gt[..., 0]) + np.square(gt[..., 1]))
    bp = (ee >= 3.0) & (ee >= 0.05 * gt_len)
    result = np.zeros(ee.shape + (3,), dtype=np.uint8)
    result[:, :, :] = (0, 255, 0)
    result[bp, :] = (255, 0, 0)
    result[nan, :] = (0, 0, 0)
    return result
