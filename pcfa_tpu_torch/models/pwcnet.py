"""PWC-DC Net (`pcfa_tpu/models/pwcnet.py`) as `nn.Module`s.

Unit-range (B, H, W, 3) images in, with H and W divisible by 64; the flow
(B, H, W, 2) out (not a tuple). Inside, the convs run NCHW; the
correlation and the warp take channels-last maps, as in the JAX package.
Semantics kept:
* RGB → BGR on entry; inputs stay in [0, 1];
* a 6-level shared conv pyramid, run on both frames as one batch;
* patch-9 local correlation (`ops/local_corr.py`, a CUDA kernel on the
  card) followed by LeakyReLU(0.1), at every level;
* `pwc_warp`: the grid is normalized by max(W−1, 1) (align_corners=True
  convention) but sampled with align_corners=False and zero padding; the
  validity mask is `grid_sample(ones) ≥ 1e-4` and carries no gradient;
* per-level flow scales 0.625 / 1.25 / 2.5 / 5.0, DenseNet decoders,
  dilated context net (padding = dilation), `20 × bilinear ×4` output
  (align_corners=False).
The warp's grid stays float32 under bf16 compute; the JAX package builds it
in the network's dtype (ROADMAP.md §3).

The pyramid's 3×3 convs with at most 64 input channels, and the context
net's dc_conv6, go through the small-conv kernel with a LeakyReLU epilogue
on CUDA (`ConvLeaky`, the routing of `_PConv3`): 11 layers per image.
Module names follow the reference torch PWCNet's `state_dict` keys, less
the unused `deconv2`.

Spans (`utils/profiling.py`): `pwcnet.pyramid` (both frames' feature
pyramid), `pwcnet.level` once for each of the five levels 6 → 2 (the
warp from level 5 on, the correlation, the decoder and the upsampled flow
and features for the next level), `pwcnet.context` (the context net and
its flow residual) and `pwcnet.upsample` (the ×4 output).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pcfa_tpu_torch.ops.local_corr import local_corr
from pcfa_tpu_torch.ops.small_conv import small_conv2d
from pcfa_tpu_torch.ops.warp import grid_sample, interpolate_bilinear
from pcfa_tpu_torch.utils import profiling

_PYRAMID = (("1", 16), ("2", 32), ("3", 64), ("4", 96), ("5", 128),
            ("6", 196))
_DECODER = (128, 128, 96, 64, 32)
_CONTEXT = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))
_SCALES = {"5": 0.625, "4": 1.25, "3": 2.5, "2": 5.0}
_PATCH = 9  # max displacement 4


class ConvLeaky(nn.Sequential):
    """`conv()` helper: 3×3 Conv2d (padding = dilation) + LeakyReLU(0.1).
    With dilation 1, at most 64 input channels, stride 1 or 2 and H, W
    divisible by the stride it runs `small_conv2d(act='leaky')` (the
    kernel on CUDA, `F.conv2d` on the CPU); otherwise `nn.Conv2d`."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__(nn.Conv2d(c_in, c_out, 3, stride, padding=dilation,
                                   dilation=dilation))
        self.conv_stride, self.dilation = stride, dilation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, s = self[0], self.conv_stride
        if (self.dilation == 1 and x.shape[1] <= 64 and s in (1, 2)
                and x.shape[2] % s == 0 and x.shape[3] % s == 0):
            return small_conv2d(x, conv.weight, conv.bias, s, act="leaky")
        return F.leaky_relu(conv(x), 0.1)


def predict_flow(c_in: int) -> nn.Conv2d:
    return nn.Conv2d(c_in, 2, 3, padding=1)


def deconv(c_in: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(c_in, 2, 4, 2, 1)


def pwc_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp with validity mask, channels-last: x (B, H, W, C),
    flow (B, H, W, 2) → (B, H, W, C) in x's dtype."""
    B, H, W, C = x.shape
    dt = torch.promote_types(x.dtype, torch.float32)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=dt, device=x.device),
                            torch.arange(W, dtype=dt, device=x.device),
                            indexing="ij")
    vx = xs + flow[..., 0].to(dt)
    vy = ys + flow[..., 1].to(dt)
    grid = torch.stack([2.0 * vx / max(W - 1, 1) - 1.0,
                        2.0 * vy / max(H - 1, 1) - 1.0], dim=-1)
    out = grid_sample(x, grid, align_corners=False, padding_mode="zeros")
    with torch.no_grad():
        ones = torch.ones((B, H, W, 1), dtype=x.dtype, device=x.device)
        mask = grid_sample(ones, grid, align_corners=False,
                           padding_mode="zeros") >= 1e-4
    return (out * mask).to(x.dtype)


class PWCDCNet(nn.Module):
    """PWC-DC Net, eval-mode output (the upsampled flow2)."""

    def __init__(self):
        super().__init__()
        nd = _PATCH ** 2
        self._stages = []
        c = 3
        for lvl, ch in _PYRAMID:
            # level 6 orders its stride-2 conv as conv6aa
            names = ((f"conv{lvl}aa", f"conv{lvl}a", f"conv{lvl}b")
                     if lvl == "6" else
                     (f"conv{lvl}a", f"conv{lvl}aa", f"conv{lvl}b"))
            for name, stride in zip(names, (2, 1, 1)):
                setattr(self, name, ConvLeaky(c, ch, stride))
                c = ch
            self._stages.append(names)
        feat_ch = dict(_PYRAMID)
        for lvl in ("6", "5", "4", "3", "2"):
            c = nd if lvl == "6" else nd + feat_ch[lvl] + 4
            for i, ch in enumerate(_DECODER):
                setattr(self, f"conv{lvl}_{i}", ConvLeaky(c, ch))
                c += ch
            setattr(self, f"predict_flow{lvl}", predict_flow(c))
            if lvl != "2":
                setattr(self, f"deconv{lvl}", deconv(2))
                setattr(self, f"upfeat{lvl}", deconv(c))
        for i, (ch, dil) in enumerate(_CONTEXT, 1):
            setattr(self, f"dc_conv{i}", ConvLeaky(c, ch, dilation=dil))
            c = ch
        self.dc_conv7 = predict_flow(c)

    def _decode(self, x: torch.Tensor, lvl: str):
        for i in range(len(_DECODER)):
            x = torch.cat([getattr(self, f"conv{lvl}_{i}")(x), x], dim=1)
        return x, getattr(self, f"predict_flow{lvl}")(x)

    def _correlate(self, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
        """Channels-last maps in, LeakyReLU'd correlation out as NCHW."""
        corr = local_corr(f1.contiguous(), f2.contiguous(), _PATCH, 1)
        return F.leaky_relu(corr, 0.1).permute(0, 3, 1, 2)

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        B = im1.shape[0]
        with profiling.span("pwcnet.pyramid"):
            x = torch.cat([im1, im2], dim=0).flip(-1).permute(0, 3, 1, 2)
            feats = {}
            for (lvl, _), names in zip(_PYRAMID, self._stages):
                for name in names:
                    x = getattr(self, name)(x)
                feats[lvl] = x.permute(0, 2, 3, 1)  # channels-last view

        with profiling.span("pwcnet.level"):
            x, flow = self._decode(self._correlate(feats["6"][:B],
                                                   feats["6"][B:]), "6")
            up_flow, up_feat = self.deconv6(flow), self.upfeat6(x)
        for lvl in ("5", "4", "3", "2"):
            with profiling.span("pwcnet.level"):
                c1, c2 = feats[lvl][:B], feats[lvl][B:]
                warped = pwc_warp(c2.contiguous(),
                                  (up_flow * _SCALES[lvl]).permute(0, 2, 3, 1))
                x = torch.cat([self._correlate(c1, warped),
                               c1.permute(0, 3, 1, 2), up_flow, up_feat],
                              dim=1)
                x, flow = self._decode(x, lvl)
                if lvl != "2":
                    up_flow = getattr(self, f"deconv{lvl}")(flow)
                    up_feat = getattr(self, f"upfeat{lvl}")(x)

        with profiling.span("pwcnet.context"):
            y = x
            for i in range(1, len(_CONTEXT) + 1):
                y = getattr(self, f"dc_conv{i}")(y)
            flow2 = (flow + self.dc_conv7(y)).permute(0, 2, 3, 1)
        with profiling.span("pwcnet.upsample"):
            H4, W4 = flow2.shape[1:3]
            return 20.0 * interpolate_bilinear(flow2, (4 * H4, 4 * W4),
                                               align_corners=False)
