"""Quick visualization helpers (`pcfa_tpu/viz/quickvis.py`).

Channels-last arrays or tensors; batches write numbered siblings like
the reference. Images are written with PIL.
"""

from __future__ import annotations

import os

import numpy as np

from pcfa_tpu_torch.utils.arrays import to_numpy
from pcfa_tpu_torch.viz.flow_plot import colorplot_light


def _ensure_dir(filename: str) -> None:
    d = os.path.dirname(filename)
    if d:
        os.makedirs(d, exist_ok=True)


def quickvis_tensor(t, filename: str) -> None:
    """Save one (H, W, C) or (1, H, W, C) array as a uint8 image."""
    from PIL import Image

    t = to_numpy(t)
    if t.ndim == 4 and t.shape[0] == 1:
        t = t[0]
    if t.ndim != 3:
        print(f"Encountered invalid tensor dimensions {t.shape}, "
              "abort printing.")
        return
    _ensure_dir(filename)
    Image.fromarray(t.astype(np.uint8)).save(filename)


def quickvisualization_tensor(t, filename: str) -> None:
    """Batch version: appends _<i>.png."""
    t = to_numpy(t)
    if t.ndim == 3 or (t.ndim == 4 and t.shape[0] == 1):
        quickvis_tensor(t, filename)
    elif t.ndim == 4:
        for i in range(t.shape[0]):
            name = filename if i == 0 else filename + f"_{i}.png"
            quickvis_tensor(t[i], name)
    else:
        print(f"Encountered unprocessable tensor dimensions {t.shape}, "
              "abort printing.")


def quickvis_flow(flow, filename: str, auto_scale: bool = True,
                  max_scale: float = -1) -> None:
    """Save one (H, W, 2) or (1, H, W, 2) flow as a color-coded PNG."""
    from PIL import Image

    flow = to_numpy(flow)
    if flow.ndim == 4 and flow.shape[0] == 1:
        flow = flow[0]
    if flow.ndim != 3:
        print(f"Encountered invalid tensor dimensions {flow.shape}, "
              "abort printing.")
        return
    _ensure_dir(filename)
    rgb = colorplot_light(flow, auto_scale=auto_scale, max_scale=max_scale)
    Image.fromarray(rgb.astype(np.uint8)).save(filename)


def quickvisualization_flow(flow, filename: str, auto_scale: bool = True,
                            max_scale: float = -1) -> None:
    """Batch version."""
    flow = to_numpy(flow)
    if flow.ndim == 3 or (flow.ndim == 4 and flow.shape[0] == 1):
        quickvis_flow(flow, filename, auto_scale, max_scale)
    elif flow.ndim == 4:
        for i in range(flow.shape[0]):
            name = filename if i == 0 else filename + f"_{i}.png"
            quickvis_flow(flow[i], name, auto_scale, max_scale)
    else:
        print(f"Encountered unprocessable tensor dimensions {flow.shape}, "
              "abort printing.")
