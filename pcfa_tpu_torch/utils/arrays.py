"""Tensors and arrays to numpy for the host side (artifacts, metrics)."""

from __future__ import annotations

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """A tensor (any device; bf16 and fp16 cast to float32 first, as
    numpy has no bf16) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)
