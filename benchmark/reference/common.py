"""Plain float32 building blocks shared by the reference networks.

Nothing here imports the program under test. Every convolution and
matrix product of a reference network goes through `Conv2d`,
`ConvTranspose2d` or `matmul` below, so that `set_precision(model,
'fp8')` can run the same network with its operands rounded to fp8: the
correctness control, one precision step below the bf16 the
configurations state. fp8 rounds each operand with a per-tensor scale
(amax / largest finite value), forward operands to e4m3 and gradients to
e5m2, as fp8 training recipes do; products accumulate in float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

PRECISIONS = ("float32", "fp8")


def plain_float32() -> None:
    """float32 products and cuDNN convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / torch.finfo(dtype).max,
                        torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _FP8(torch.autograd.Function):
    """Operand rounding: e4m3 on the way in, e5m2 for the gradient."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    return _FP8.apply(x) if precision == "fp8" else x


class Conv2d(nn.Conv2d):
    precision = "float32"

    def forward(self, x):
        p = self.precision
        return F.conv2d(rounded(x, p), rounded(self.weight, p), self.bias,
                        self.stride, self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    precision = "float32"

    def forward(self, x):
        p = self.precision
        return F.conv_transpose2d(rounded(x, p), rounded(self.weight, p),
                                  self.bias, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return torch.matmul(rounded(a, precision), rounded(b, precision))


def set_precision(model: nn.Module, precision: str) -> nn.Module:
    """Run every product of `model` in `precision` ('float32' or 'fp8')."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    model.precision = precision
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.precision = precision
    return model


def pad_amounts(hw, divisor: int, mode: str) -> tuple[int, int, int, int]:
    """(left, right, top, bottom) replicate padding up to a multiple of
    `divisor`: 'sintel' centres it in both axes, other modes ('kitti') pad
    the bottom only and centre the width (RAFT's InputPadder)."""
    h, w = hw
    ph = (-h) % divisor
    pw = (-w) % divisor
    if mode == "sintel":
        return pw // 2, pw - pw // 2, ph // 2, ph - ph // 2
    return pw // 2, pw - pw // 2, 0, ph


def pad(x: torch.Tensor, amounts) -> torch.Tensor:
    """Replicate-pad (B, H, W, C)."""
    left, right, top, bottom = amounts
    y = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom),
              mode="replicate")
    return y.permute(0, 2, 3, 1)


def unpad(x: torch.Tensor, amounts) -> torch.Tensor:
    left, right, top, bottom = amounts
    H, W = x.shape[1], x.shape[2]
    return x[:, top:H - bottom, left:W - right]


def read_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A published checkpoint as a flat state dict: a {'state_dict': …}
    wrapper is opened and a DataParallel `module.` prefix dropped."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in state:
        state = state["state_dict"]
    return {k.removeprefix("module."): v for k, v in state.items()}
