"""Shared CLI plumbing (`pcfa_tpu/cli/common.py`): device, model and data
setup, target building, metrics."""

from __future__ import annotations

import sys

import numpy as np
import torch

from pcfa_tpu_torch._device import resolve_device
from pcfa_tpu_torch.attack.losses import avg_epe
from pcfa_tpu_torch.attack.targets import make_target_fn
from pcfa_tpu_torch.data import prepare_dataloader
from pcfa_tpu_torch.runtime import LoadedModel, load_model
from pcfa_tpu_torch.utils.arrays import to_numpy


def setup_runtime(device: str | torch.device = "cuda") -> torch.device:
    """The device the run uses: CUDA raises where there is none, and
    float32 stays float32 on the card (no TF32)."""
    return resolve_device(device)


def load_attack_model(args, device: torch.device) -> LoadedModel:
    """Load the net under attack on `device`; fall back to deterministic
    random weights (seed 0) with a loud warning when no checkpoint is
    available (the reference exits instead)."""
    checkpoint = getattr(args, "checkpoint", None)
    try:
        return load_model(args.net, checkpoint=checkpoint, device=device)
    except FileNotFoundError as e:
        print(f"WARNING: {e}", file=sys.stderr)
        print(
            "WARNING: proceeding with RANDOM-INIT weights — attack metrics "
            "will not correspond to the pretrained network.",
            file=sys.stderr,
        )
        return load_model(args.net, checkpoint=checkpoint, init_random=True,
                          device=device)


def make_loader(args, batch_size=1, shuffle=False):
    return prepare_dataloader(
        mode=args.dataset_stage,
        dataset=args.dataset,
        shuffle=shuffle,
        batch_size=batch_size,
        small_run=args.small_run,
        dstype=args.dstype,
    )


def pad_mode_for(dataset: str) -> str:
    # the reference pads every dataset in 'sintel' (centred) mode
    return "sintel"


def build_target(args, flow_pred_init: torch.Tensor) -> torch.Tensor:
    """zero / neg_flow / custom (the file read once per call, fitted to
    the prediction's size and repeated over the batch)."""
    return make_target_fn(args.target, args.custom_target_path)(
        flow_pred_init)


def epe(a, b) -> float:
    """Average endpoint error of two (..., H, W, 2) flows, tensors or
    arrays (moved to the first tensor's device)."""
    dev = next((t.device for t in (a, b) if isinstance(t, torch.Tensor)),
               torch.device("cpu"))
    a, b = (torch.as_tensor(t, device=dev) for t in (a, b))
    return float(avg_epe(a, b))


def unit_images(img1: np.ndarray, img2: np.ndarray, device: torch.device):
    """Dataset batches arrive in [0, 255]; the attack works in unit scale.
    The division happens on `device`."""
    return tuple(torch.from_numpy(np.asarray(x, np.float32)).to(device)
                 / 255.0 for x in (img1, img2))


def host_metrics(metrics, cls):
    """An engine's metrics (a NamedTuple of tensors of one shape), stacked
    on the device and copied to the host once, as `cls` of numpy arrays
    (float64 holds every float32 value)."""
    stacked = torch.stack([v.to(torch.float64) for v in metrics])
    return cls(*to_numpy(stacked))


def progress(iterable):
    """`tqdm` over `iterable` where it is installed, else the iterable."""
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable)


def should_save(batch: int, args) -> bool:
    """Artifact cadence."""
    if args.no_save:
        return False
    if args.small_save:
        return batch < 32
    return batch % args.save_frequency == 0
