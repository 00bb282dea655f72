"""Interactive flow-file viewer (matplotlib slider/radio GUI).

The port's own copy of `pcfa_tpu/viz/flow_show.py`.

Rebuild of `flow_library/flow_show.py:16-129`: color-coded visualization of a
flow file with a max-scale slider, visualization-type radio buttons (light /
dark / log / error maps), arrow-key navigation through the directory, and
AEE/Fl display when a ground truth is auto-discovered.

Usage: python -m pcfa_tpu_torch.viz.flow_show <flowfile>
"""

from __future__ import annotations

import os
import sys

import numpy as np

from pcfa_tpu_torch.data import flow_datasets
from pcfa_tpu_torch.io import read_flow
from pcfa_tpu_torch.metrics import get_all_error_measures
from pcfa_tpu_torch.viz import flow_plot

VIS_TYPES = ["Color Light", "Color Dark", "Color Log", "Color LogLog",
             "Error", "Error Fl"]


def get_flow_vis(flow, vistype="Color Light", auto_scale=False, max_scale=-1,
                 gt=None, return_max=False):
    """Dispatch to the requested visualization (`flow_show.py:16-34`)."""
    if vistype == "Color Light":
        return flow_plot.colorplot_light(
            flow, auto_scale=auto_scale, max_scale=max_scale,
            return_max=return_max)
    if vistype == "Color Dark":
        return flow_plot.colorplot_dark(
            flow, auto_scale=auto_scale, max_scale=max_scale,
            return_max=return_max)
    if vistype == "Color Log":
        return flow_plot.colorplot_dark(
            flow, auto_scale=auto_scale, transform="log",
            max_scale=max_scale, return_max=return_max)
    if vistype == "Color LogLog":
        return flow_plot.colorplot_dark(
            flow, auto_scale=auto_scale, transform="loglog",
            max_scale=max_scale, return_max=return_max)
    if vistype == "Error":
        if gt is None:
            return np.zeros(flow.shape[:2])
        return flow_plot.errorplot(flow, gt)
    if vistype == "Error Fl":
        if gt is None:
            return np.zeros(flow.shape[:2])
        return flow_plot.errorplot_Fl(flow, gt)
    raise ValueError(f"unknown vistype {vistype}")


def show_flow(filepath: str) -> None:  # pragma: no cover - interactive
    import matplotlib.pyplot as plt
    from matplotlib.widgets import RadioButtons, Slider

    flow = read_flow(filepath)
    gt_flow = None

    dir_name = os.path.dirname(filepath) or "."
    dir_entries = [os.path.join(dir_name, e)
                   for e in sorted(os.listdir(dir_name))]

    fig, ax = plt.subplots()
    try:
        fig.canvas.manager.set_window_title(filepath)
    except Exception:
        pass
    plt.subplots_adjust(left=0, right=1, bottom=0.2)

    rgb, max_scale = get_flow_vis(flow, auto_scale=True, return_max=True)
    plt.axis("off")
    implot = plt.imshow(rgb, interpolation="nearest")

    axslider = plt.axes([0.05, 0.085, 0.6, 0.03])
    axbuttons = plt.axes([0.7, 0.005, 0.25, 0.195], frame_on=False,
                         aspect="equal")
    slider = Slider(axslider, "max", valmin=0, valmax=200,
                    valinit=max_scale, closedmin=False)
    buttons = RadioButtons(axbuttons, VIS_TYPES)

    def refresh(load: bool = False):
        nonlocal flow, gt_flow
        if load:
            flow = read_flow(filepath)
            gt_flow = None
            try:
                gt = flow_datasets.findGroundtruth(filepath)
                if gt:
                    gt_flow = read_flow(gt)
                    errors = get_all_error_measures(flow, gt_flow)
                    fig.suptitle(f"AEE: {errors['AEE']:.3f}, "
                                 f"Fl: {errors['Fl']:.3f}")
            except Exception as e:
                print(e)
        vis = get_flow_vis(flow, vistype=buttons.value_selected,
                           max_scale=slider.val, gt=gt_flow)
        implot.set_data(vis)
        fig.canvas.draw_idle()

    def format_coord(x, y):
        i, j = int(x + 0.5), int(y + 0.5)
        if 0 <= i < flow.shape[1] and 0 <= j < flow.shape[0]:
            return (f"pos: ({i: 4d},{j: 4d}), "
                    f"flow: ({flow[j, i, 0]: 4.2f}, {flow[j, i, 1]: 4.2f}) ")
        return f"x={x:1.4f}, y={y:1.4f}"

    def on_key(event):
        nonlocal filepath
        if event.key not in ("left", "right"):
            return
        idx = dir_entries.index(filepath)
        if event.key == "left" and idx > 0:
            filepath = dir_entries[idx - 1]
            refresh(load=True)
        elif event.key == "right" and idx < len(dir_entries) - 1:
            filepath = dir_entries[idx + 1]
            refresh(load=True)

    ax.format_coord = format_coord
    fig.canvas.mpl_connect("key_press_event", on_key)
    slider.on_changed(lambda _val: refresh())
    buttons.on_clicked(lambda _lbl: refresh())
    refresh(load=True)
    plt.show()


if __name__ == "__main__":
    if len(sys.argv) > 1:
        show_flow(sys.argv[1])
    else:
        print(f"Usage:\n  {sys.argv[0]} <flowfile>")
        sys.exit(1)
