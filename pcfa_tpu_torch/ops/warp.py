"""Sampling and pooling primitives of the RAFT path (channels-last public
layout, like `pcfa_tpu/ops/warp.py`): images (B, H, W, C), point grids
(B, Hg, Wg, 2) with (x, y) in the last axis."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def coords_grid(batch: int, ht: int, wd: int,
                device: str | torch.device | None = None) -> torch.Tensor:
    """Pixel-coordinate grid (B, H, W, 2), float32, (x, y) channels."""
    y, x = torch.meshgrid(torch.arange(ht, device=device),
                          torch.arange(wd, device=device), indexing="ij")
    coords = torch.stack([x, y], dim=-1).to(torch.float32)
    return coords[None].expand(batch, ht, wd, 2)


def avg_pool2d(img: torch.Tensor, window: int = 2,
               stride: int | None = None) -> torch.Tensor:
    """Average pooling on (B, H, W, C), VALID padding (odd sizes floor:
    47 → 23 → 11 → 5)."""
    stride = stride or window
    out = F.avg_pool2d(img.permute(0, 3, 1, 2), window, stride)
    return out.permute(0, 2, 3, 1)


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """RAFT-style sampling at absolute pixel coordinates: normalize with
    align_corners=True, grid-sample with zero padding.

    img: (B, H, W, C); coords: (B, Hg, Wg, 2) → (B, Hg, Wg, C)."""
    # at least float32 (a bf16 grid cannot hold pixel positions); float64
    # stays float64, so a float64 model is float64 end to end
    dt = torch.promote_types(img.dtype, torch.float32)
    H, W = img.shape[1], img.shape[2]
    coords = coords.to(dt)
    xgrid = 2.0 * coords[..., 0] / (W - 1) - 1.0
    ygrid = 2.0 * coords[..., 1] / (H - 1) - 1.0
    grid = torch.stack([xgrid, ygrid], dim=-1)
    out = F.grid_sample(img.permute(0, 3, 1, 2).to(dt), grid,
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.permute(0, 2, 3, 1).to(img.dtype)
