"""SpyNet (`pcfa_tpu/models/spynet.py`) as `nn.Module`s: a 6-level
coarse-to-fine spatial pyramid.

Unit-range (B, H, W, 3) images in, with H and W divisible by 2^nlevels
(64); the flow (B, H, W, 2) out (not a tuple). Images, warps and flows are
channels-last as in the JAX package; each level's `BasicBlock` runs NCHW.
Semantics kept:
* ImageNet normalization `(x − mean) / std` in the images' dtype;
* the image pyramid by repeated 2×2 average pooling;
* the initial flow is zeros at half the coarsest level; per level it is
  upsampled ×2 (bilinear, align_corners=False) and doubled, frame 2 is
  warped by it (`spynet_warp`), and a `BasicBlock` of five 7×7 convs
  (8→32→64→32→16→2, ReLU after the first four) adds its residual.
Each conv is `small_conv2d` (`Conv7`): the CUDA kernel on the card,
`F.conv2d` on the CPU, as the JAX package runs its Pallas kernel on a TPU.
Under bf16 compute the convs take the weights' dtype while the upsampled
flow, the warp's output and the flow between levels stay float32 (the
JAX package's promotion). The warp's grid is float32 under every compute
dtype; the JAX package builds it in the images' dtype (ROADMAP.md §3).

Module names follow the reference: `moduleBasic.{level}` holds level
`level`'s block (coarsest first), whose `moduleBasic` Sequential has the
reference's layers, convs at even indices and ReLUs at odd ones (the
forward fuses each ReLU into the conv before it).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pcfa_tpu_torch.ops.small_conv import small_conv2d
from pcfa_tpu_torch.ops.warp import (
    avg_pool2d,
    grid_sample,
    interpolate_bilinear,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_CHANNELS = (8, 32, 64, 32, 16, 2)


def preprocess(x: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization of (B, H, W, 3) images, in their dtype."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def spynet_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp with SpyNet's grid: linspace(−1, 1) per axis
    (align_corners=True spacing) plus the flow over (size − 1)/2, clipped
    to [−1, 1], sampled with align_corners=False and zero padding by
    `ops/warp.grid_sample` (its backward is the `warp_bwd` kernel on the
    card). img (B, H, W, C), flow (B, H, W, 2) → (B, H, W, C) in the
    promoted dtype, at least float32. The grid is built in float32 (float64
    for float64 inputs). The clip is max then min, whose derivative is ½
    exactly on a bound, as `jnp.clip`'s (`torch.clamp` gives 1 there)."""
    B, H, W, _ = img.shape
    dt = torch.promote_types(torch.promote_types(img.dtype, flow.dtype),
                             torch.float32)
    xs = torch.linspace(-1.0, 1.0, W, dtype=dt, device=img.device)
    ys = torch.linspace(-1.0, 1.0, H, dtype=dt, device=img.device)
    base = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
    norm = torch.tensor([(W - 1.0) / 2.0, (H - 1.0) / 2.0], dtype=dt,
                        device=img.device)
    grid = base[None] + flow.to(dt) / norm
    one = torch.ones((), dtype=dt, device=img.device)
    grid = torch.minimum(torch.maximum(grid, -one), one)
    return grid_sample(img, grid, align_corners=False, padding_mode="zeros")


class Conv7(nn.Conv2d):
    """One 7×7 SAME conv with an optional fused ReLU, through
    `small_conv2d`. Its input is cast to the weight's dtype first: under
    bf16 the warp and the upsampling hand it float32."""

    def __init__(self, c_in: int, c_out: int, relu: bool = False):
        super().__init__(c_in, c_out, 7, padding=3)
        self.act = "relu" if relu else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return small_conv2d(x.to(self.weight.dtype), self.weight, self.bias,
                            1, self.act)


class BasicBlock(nn.Module):
    """Five `Conv7`s, 8→32→64→32→16→2, ReLU after the first four. NHWC in
    and out, NCHW inside."""

    def __init__(self):
        super().__init__()
        layers = []
        for i, (c_in, c_out) in enumerate(zip(_CHANNELS, _CHANNELS[1:])):
            if i:
                layers.append(nn.ReLU())
            layers.append(Conv7(c_in, c_out, relu=i < 4))
        self.moduleBasic = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for conv in self.moduleBasic[::2]:
            x = conv(x)
        return x.permute(0, 2, 3, 1)


class SpyNet(nn.Module):
    """Coarse-to-fine pyramid network, eval mode; `moduleBasic[i]` takes
    pyramid level i, coarsest first."""

    def __init__(self, nlevels: int = 6):
        super().__init__()
        self.nlevels = nlevels
        self.moduleBasic = nn.ModuleList(BasicBlock() for _ in range(nlevels))

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        pyr1, pyr2 = [preprocess(img1)], [preprocess(img2)]
        for _ in range(self.nlevels - 1):
            pyr1.insert(0, avg_pool2d(pyr1[0], 2, 2))
            pyr2.insert(0, avg_pool2d(pyr2[0], 2, 2))

        B, h0, w0, _ = pyr1[0].shape
        flow = torch.zeros((B, h0 // 2, w0 // 2, 2), dtype=img1.dtype,
                           device=img1.device)
        for lvl, block in enumerate(self.moduleBasic):
            H, W = pyr1[lvl].shape[1:3]
            up = interpolate_bilinear(flow, (H, W), align_corners=False) * 2.0
            warped = spynet_warp(pyr2[lvl], up)
            inp = torch.cat([pyr1[lvl], warped, up], dim=-1)
            flow = block(inp) + up
        return flow
