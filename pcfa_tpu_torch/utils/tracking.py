"""Experiment tracking and artifact writers (`pcfa_tpu/utils/tracking.py`).

The same experiment naming (`{net}_{attack}_{dd|cd}_{-|u}[_eval]`), metric
vocabulary and artifacts as the JAX package: `{batch:05d}_{name}.npy` in
the reference's NCHW layout, so that either package's evaluator reads the
other's perturbations, and `{batch:05d}_{name}.png` images written with
PIL. Arrays may be numpy arrays or tensors on any device.

Backend: MLflow when importable, else a JSONL sink (`params.json` +
`metrics.jsonl` per run folder).
"""

from __future__ import annotations

import datetime
import json
import os
from os import path

import numpy as np

from pcfa_tpu_torch.utils.arrays import to_numpy
from pcfa_tpu_torch.viz.flow_plot import colorplot_light

try:
    import mlflow  # optional
except ImportError:
    mlflow = None


def _to_nchw(arr: np.ndarray) -> np.ndarray:
    """(B, H, W, C) / (H, W, C) → reference NCHW / CHW layout."""
    if arr.ndim == 4:
        return np.transpose(arr, (0, 3, 1, 2))
    if arr.ndim == 3:
        return np.transpose(arr, (2, 0, 1))
    return arr


def create_subfolder(main_folder: str, name: str) -> str:
    p = path.join(main_folder, name)
    os.makedirs(p, exist_ok=True)
    return p


class Tracker:
    """Params/metrics/artifacts for one experiment run."""

    def __init__(
        self,
        output_folder: str,
        net: str,
        attack_name: str,
        joint_perturbation: bool,
        universal_perturbation: bool,
        stage: str = "train",
        use_mlflow: bool | None = None,
    ):
        c_p = "cd" if joint_perturbation else "dd"
        u_p = "u" if universal_perturbation else "-"
        exp_name = "_".join([net, attack_name, c_p, u_p])
        if stage == "eval":
            exp_name += "_eval"
        self.experiment_name = exp_name

        datestr = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        self.folder_name = f"{datestr}_{exp_name}"
        self.folder_path = create_subfolder(
            create_subfolder(output_folder, exp_name), self.folder_name)

        self._use_mlflow = (
            use_mlflow if use_mlflow is not None
            else (mlflow is not None and not os.environ.get("PCFA_NO_MLFLOW"))
        )
        self._run = None
        self._params_file = path.join(self.folder_path, "params.json")
        self._metrics_file = path.join(self.folder_path, "metrics.jsonl")
        self._params: dict = {}
        self._metrics_fh = None

    # ------------------------------------------------------------- run mgmt
    def __enter__(self):
        if self._use_mlflow:
            if mlflow.get_experiment_by_name(self.experiment_name) is None:
                mlflow.create_experiment(self.experiment_name)
            exp = mlflow.get_experiment_by_name(self.experiment_name)
            self._run = mlflow.start_run(experiment_id=exp.experiment_id,
                                         run_name=self.folder_name)
        self._metrics_fh = open(self._metrics_file, "a")
        return self

    def __exit__(self, *exc):
        if self._metrics_fh:
            self._metrics_fh.close()
        with open(self._params_file, "w") as f:
            json.dump(self._params, f, indent=1, default=str)
        if self._run is not None:
            mlflow.end_run()
        return False

    # -------------------------------------------------------------- logging
    def log_param(self, key, value):
        self._params[key] = value
        if self._run is not None:
            mlflow.log_param(key, value)

    def log_params(self, **kwargs):
        for k, v in kwargs.items():
            self.log_param(k, v)

    def log_metric(self, key, value, step=0):
        if value is None:
            return
        self._metrics_fh.write(
            json.dumps({"key": key, "value": float(value), "step": int(step)})
            + "\n")
        if self._run is not None:
            mlflow.log_metric(key=key, value=float(value), step=int(step))

    def log_metrics(self, step, *pairs):
        for key, value in pairs:
            self.log_metric(key, value, step)

    def log_averages(self, numsteps, *pairs):
        out = {}
        for key, total in pairs:
            if total is not None:
                out[key] = total / numsteps
                self.log_metric(key, out[key])
        return out

    def register_artifact(self, filepath):
        if self._run is not None:
            mlflow.log_artifact(filepath)


# ------------------------------------------------------------- artifacts ---

def save_tensor(arr, name: str, batch: int, folder: str,
                tracker: Tracker | None = None, register: bool = False):
    """`.npy` in the reference's `{batch:05d}_{name}.npy` naming and NCHW
    layout."""
    filepath = path.join(folder, f"{batch:05d}_{name}.npy")
    np.save(filepath, _to_nchw(to_numpy(arr)))
    if register and tracker is not None:
        tracker.register_artifact(filepath)
    return filepath


def save_image(arr, batch: int, folder: str, image_name: str = "image",
               unit_input: bool = True, normalize_max: float | None = None,
               tracker: Tracker | None = None, register: bool = False):
    """Normalized PNG: optional symmetric normalization around 0.5, ×255
    for unit input. arr: (B|1, H, W, C) or (H, W, C), unit scale."""
    from PIL import Image

    data = to_numpy(arr).astype(np.float64)
    if data.ndim == 4:
        data = data[0]
    if normalize_max is not None and normalize_max != 0:
        data = data / normalize_max / 2.0 + 0.5
        unit_input = True
    if unit_input:
        data = data * 255.0
    filepath = path.join(folder, f"{batch:05d}_{image_name}.png")
    Image.fromarray(np.clip(data, 0, 255).astype(np.uint8)).save(filepath)
    if register and tracker is not None:
        tracker.register_artifact(filepath)
    return filepath


def save_flow(flow, batch: int, folder: str, flow_name: str = "flowgt",
              auto_scale: bool = True, max_scale: float = -1,
              tracker: Tracker | None = None, register: bool = False):
    """Color-coded flow PNG. flow: (B|1, H, W, 2) / (H, W, 2)."""
    from PIL import Image

    data = to_numpy(flow).astype(np.float64)
    if data.ndim == 4:
        data = data[0]
    rgb = colorplot_light(data, auto_scale=auto_scale, max_scale=max_scale)
    filepath = path.join(folder, f"{batch:05d}_{flow_name}.png")
    Image.fromarray(rgb.astype(np.uint8)).save(filepath)
    if register and tracker is not None:
        tracker.register_artifact(filepath)
    return filepath


def max_flow_length(*flows) -> float:
    """Length of the longest flow vector over the given fields (None
    skipped): the corrected form of the reference's `flow_length`, which
    forgets to square; used only to scale the flow plots."""
    m = 0.0
    for f in flows:
        if f is None:
            continue
        f = to_numpy(f)
        m = max(m, float(np.sqrt((f ** 2).sum(-1)).max()))
    return m
