"""RAFT-family building blocks (`pcfa_tpu/models/layers.py`) as
`nn.Module`s on NCHW, eval-mode: BatchNorm is folded into a per-channel
scale/bias (`FrozenBatchNorm`), InstanceNorm is the parameter-free
biased-variance form. Module names follow the reference torch RAFT's
`state_dict` keys.

In `BasicEncoder` (RAFT, GMA) the stem (7×7/2, 3→64) and the four 3×3
layer1 convs go through the small-conv kernel (`ops/small_conv.py`) on
CUDA, as the Pallas kernel runs them on a TPU; every other conv, and every
conv of RAFT-small's `SmallEncoder` (which the JAX package also leaves to
XLA), is `F.conv2d`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pcfa_tpu_torch.ops.small_conv import small_conv2d


class FrozenBatchNorm(nn.Module):
    """Eval-mode BatchNorm with its running statistics folded in:
    x·scale + bias per channel."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale[:, None, None] + self.bias[:, None, None]


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch `nn.InstanceNorm2d` (affine=False): per sample and channel
    over H, W, biased variance."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps)


class InstanceNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


def make_norm(norm_fn: str, features: int) -> nn.Module:
    if norm_fn == "batch":
        return FrozenBatchNorm(features)
    if norm_fn == "instance":
        return InstanceNorm()
    if norm_fn == "none":
        return nn.Identity()
    raise ValueError(f"unsupported norm_fn: {norm_fn}")


class SmallConv(nn.Conv2d):
    """SAME k×k conv (torch padding k//2) through `small_conv2d`: the CUDA
    kernel for CUDA tensors, `F.conv2d` for CPU tensors. Same parameters
    as `nn.Conv2d`."""

    def __init__(self, c_in: int, c_out: int, ksize: int, stride: int = 1):
        super().__init__(c_in, c_out, ksize, stride, padding=ksize // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return small_conv2d(x, self.weight, self.bias, self.stride[0])


class ResidualBlock(nn.Module):
    """Two 3×3 convs + norm + ReLU, with a strided 1×1 conv + norm
    shortcut when stride ≠ 1. `small` routes the 3×3 convs through the
    small-conv kernel (layer1)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance",
                 stride: int = 1, small: bool = False):
        super().__init__()
        if small:
            self.conv1 = SmallConv(in_planes, planes, 3, stride)
            self.conv2 = SmallConv(planes, planes, 3)
        else:
            self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, padding=1)
            self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride),
                make_norm(norm_fn, planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class BasicEncoder(nn.Module):
    """7×7/2 stem + three residual stages (64, 96, 128; strides 1/2/2) +
    1×1 output conv → ÷8 feature map. NCHW in and out."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "instance"):
        super().__init__()
        self.conv1 = SmallConv(3, 64, 7, 2)
        self.norm1 = make_norm(norm_fn, 64)
        self.layer1 = nn.Sequential(
            ResidualBlock(64, 64, norm_fn, 1, small=True),
            ResidualBlock(64, 64, norm_fn, 1, small=True))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm_fn, 2),
                                    ResidualBlock(96, 96, norm_fn, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm_fn, 2),
                                    ResidualBlock(128, 128, norm_fn, 1))
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class BottleneckBlock(nn.Module):
    """1×1 → 3×3 (stride) → 1×1 bottleneck, each conv followed by norm and
    ReLU, with a strided 1×1 conv + norm shortcut when stride ≠ 1
    (RAFT-small's encoders)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance",
                 stride: int = 1):
        super().__init__()
        p4 = planes // 4
        self.conv1 = nn.Conv2d(in_planes, p4, 1)
        self.conv2 = nn.Conv2d(p4, p4, 3, stride, padding=1)
        self.conv3 = nn.Conv2d(p4, planes, 1)
        self.norm1 = make_norm(norm_fn, p4)
        self.norm2 = make_norm(norm_fn, p4)
        self.norm3 = make_norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride),
                make_norm(norm_fn, planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        y = torch.relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class SmallEncoder(nn.Module):
    """7×7/2 stem (32) + bottleneck stages (32, 64, 96; strides 1/2/2) +
    1×1 output conv → ÷8 feature map. NCHW in and out."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 7, 2, padding=3)
        self.norm1 = make_norm(norm_fn, 32)
        c = 32
        for i, (dim, stride) in enumerate(((32, 1), (64, 2), (96, 2)), 1):
            setattr(self, f"layer{i}", nn.Sequential(
                BottleneckBlock(c, dim, norm_fn, stride),
                BottleneckBlock(dim, dim, norm_fn, 1)))
            c = dim
        self.conv2 = nn.Conv2d(96, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)
