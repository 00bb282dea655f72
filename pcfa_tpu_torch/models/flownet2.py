"""FlowNet2 (`pcfa_tpu/models/flownet2.py`) as `nn.Module`s: the cascade
FlowNetC → FlowNetS 1 → FlowNetS 2 ∥ FlowNetSD → FlowNetFusion.

Unit-range (B, H, W, 3) images in, with H and W divisible by 64; the flow
(B, H, W, 2) out (not a tuple). The sub-nets run NCHW; the cascade's
warps, norms and flows are channels-last, as in the JAX package.
Semantics kept (the reference's batchNorm=False config):
* the per-sample, per-channel mean over both frames is subtracted;
* FlowNetC's correlation is the patch correlation, patch 21 and stride 2
  (displacements ±20, 441 channels, dy-major, divided by C) through
  `ops/local_corr.py` (a CUDA kernel on the card), then LeakyReLU(0.1);
* div_flow 20 between the stages; bilinear ×4 (align_corners=False) for
  FlowNetC's and FlowNetS 1's flows, nearest ×4 for FlowNetS 2's and
  FlowNetSD's;
* four `resample2d` warps (per-corner border clamp) and six
  `channel_norm`s.

Routing, as the JAX package routes its Pallas kernel on a TPU (the gates
depend on shapes only, so the CPU runs the same construction through the
plain versions):
* `CL` (conv + LeakyReLU(0.1)): `small_conv2d(act='leaky')` when C_in ≤ 64,
  the stride is 1 or 2 and H, W are divisible by it (14 per forward);
* `PlainConv` (`IConv`, `predict_flow`): `small_conv2d` when C_out ≤ 32
  and C_in ≤ 192 (7 per forward);
* `Deconv` / the flow upsamplers (`ConvTranspose2d(4, 2, 1)`): when C_out
  ≤ 32 and C_in ≤ 192, one stride-1 3×3 `small_conv2d` with 4·C_out
  outputs and `pixel_shuffle` (20 per forward, `combined_deconv_weight`);
the rest is cuDNN (`nn.Conv2d`, `nn.ConvTranspose2d`).

Dtypes: each routed conv and each sub-net's first conv casts its input to
the weights' dtype, so under bf16 every sub-net runs in bf16, as the JAX
package's `_PConv` casts on a TPU. Each sub-net's flow leaves it as
float32: the ×20 and ÷20, the resizes, the warps (whose grids are float32
too) and the norms are float32 (ROADMAP.md §3).

Module names follow the reference `state_dict` keys
(`flownetc.conv1.0.weight`, `flownets_1.upsampled_flow6_to_5.weight`,
`flownetfusion.inter_conv0.0.bias`, ...); FlowNetS's flow upsamplers have
no bias.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pcfa_tpu_torch.ops.channelnorm import channel_norm
from pcfa_tpu_torch.ops.local_corr import local_corr
from pcfa_tpu_torch.ops.small_conv import small_conv2d
from pcfa_tpu_torch.ops.warp import interpolate_bilinear, resample2d

DIV_FLOW = 20.0


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class CL(nn.Sequential):
    """`submodules.conv` (no BatchNorm): Conv2d(k, stride, (k−1)/2) +
    LeakyReLU(0.1), through the small conv where the JAX gate allows."""

    def __init__(self, c_in: int, c_out: int, k: int = 3, stride: int = 1):
        super().__init__(nn.Conv2d(c_in, c_out, k, stride, (k - 1) // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self[0]
        s = conv.stride[0]
        x = x.to(conv.weight.dtype)
        if (x.shape[1] <= 64 and s in (1, 2) and x.shape[2] % s == 0
                and x.shape[3] % s == 0):
            return small_conv2d(x, conv.weight, conv.bias, s, "leaky")
        return _leaky(conv(x))


class PlainConv(nn.Conv2d):
    """A bias'd stride-1 SAME conv without activation (`predict_flow`, the
    conv of `i_conv`), through the small conv when C_out ≤ 32 and C_in ≤
    192."""

    def __init__(self, c_in: int, c_out: int, k: int = 3):
        super().__init__(c_in, c_out, k, padding=(k - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        if self.out_channels <= 32 and self.in_channels <= 192:
            return small_conv2d(x, self.weight, self.bias, 1)
        return super().forward(x)


class IConv(nn.Sequential):
    """`submodules.i_conv`: a conv without activation (Sequential of one)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__(PlainConv(c_in, c_out))


# ConvTranspose2d(4, 2, 1) as a 3×3 conv per output parity r: the output
# 2u + r reads the input at u + offset with tap t, {offset + 1: t}
_PARITY_TAPS = ({0: 3, 1: 1}, {1: 2, 2: 0})


def combined_deconv_weight(weight: torch.Tensor,
                           bias: torch.Tensor | None):
    """The `ConvTranspose2d(k=4, stride 2, padding 1)` weight (C_in, C_out,
    4, 4) as the weight (4·C_out, C_in, 3, 3) of one stride-1 SAME conv
    whose output, `pixel_shuffle`d by 2, is the transposed conv's: output
    channel o·4 + ry·2 + rx holds parity (ry, rx) of channel o (the JAX
    package orders them (ry·2 + rx)·C_out + o and interleaves by reshape).
    Each parity reads two taps per axis at input offsets in {−1, 0, +1};
    the other five of its nine are zero. The bias repeats per parity."""
    c_in, co = weight.shape[:2]
    w3 = weight.new_zeros((co, 2, 2, c_in, 3, 3))
    for ry, ys in enumerate(_PARITY_TAPS):
        for rx, xs in enumerate(_PARITY_TAPS):
            for a, ty in ys.items():
                for b, tx in xs.items():
                    w3[:, ry, rx, :, a, b] = weight[:, :, ty, tx].t()
    b4 = None if bias is None else bias.repeat_interleave(4)
    return w3.reshape(4 * co, c_in, 3, 3), b4


class Deconv(nn.ConvTranspose2d):
    """`ConvTranspose2d(c_in, c_out, 4, 2, 1)`, with LeakyReLU(0.1) for
    `submodules.deconv` (`act='leaky'`) or bare for a flow upsampler. When
    C_out ≤ 32 and C_in ≤ 192 it runs as one 3×3 `small_conv2d` with the
    combined weight (kept per weight tensor: built again only when the
    weight is replaced, changes dtype or device, or is written in place)
    and `pixel_shuffle`; otherwise cuDNN's transposed conv."""

    def __init__(self, c_in: int, c_out: int, bias: bool = True,
                 act: str | None = None):
        super().__init__(c_in, c_out, 4, 2, 1, bias=bias)
        self.act = act
        self._combined = (None, None)

    def combined(self):
        w, b = self.weight, self.bias
        if w.requires_grad or (b is not None and b.requires_grad):
            return combined_deconv_weight(w, b)
        key = tuple((id(t), t.data_ptr(), t.dtype, t.device, t._version)
                    for t in (w, b) if t is not None)
        if self._combined[0] != key:
            with torch.no_grad():
                self._combined = (key, combined_deconv_weight(w, b))
        return self._combined[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        if self.out_channels <= 32 and self.in_channels <= 192:
            w3, b4 = self.combined()
            return F.pixel_shuffle(small_conv2d(x, w3, b4, 1, self.act), 2)
        out = super().forward(x)
        return _leaky(out) if self.act == "leaky" else out


class _Deconv(nn.Sequential):
    """`submodules.deconv`: the leaky transposed conv as a Sequential of
    one (state_dict keys `deconv5.0.weight`, ...)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__(Deconv(c_in, c_out, act="leaky"))


def upsample_nearest4(x: torch.Tensor) -> torch.Tensor:
    """torch `nn.Upsample(scale_factor=4, mode='nearest')` on (B, H, W, C)."""
    return x.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)


def _flow_out(flow: torch.Tensor) -> torch.Tensor:
    """A sub-net's NCHW flow as a float32 (float64 stays) channels-last
    tensor."""
    dt = torch.promote_types(flow.dtype, torch.float32)
    return flow.permute(0, 2, 3, 1).to(dt)


class _CascadeNet(nn.Module):
    """What FlowNetC, FlowNetS and FlowNetSD share: the encoder's tail
    conv4 (÷32) … conv6_1 (÷64, 1024 channels), and the decoder from the
    ÷64 features up to the ÷4 flow: per level a flow prediction, its
    upsampler, a leaky deconv of the features and a concat with the skip
    (FlowNetSD puts an `i_conv` before each prediction but the first).
    The layers sit on the sub-net itself, as the reference names them."""

    def _add_tail(self, up_bias: bool, inter: bool = False) -> None:
        self.conv4 = CL(256, 512, 3, 2)
        self.conv4_1 = CL(512, 512)
        self.conv5 = CL(512, 512, 3, 2)
        self.conv5_1 = CL(512, 512)
        self.conv6 = CL(512, 1024, 3, 2)
        self.conv6_1 = CL(1024, 1024)
        self.inter = inter
        c = 1024
        for lvl, skip, dec in zip((6, 5, 4, 3, 2), (512, 512, 256, 128, None),
                                  (512, 256, 128, 64, None)):
            pred_in = c
            if inter and lvl < 6:
                pred_in = 2 ** (lvl + 4)  # 512, 256, 128, 64
                setattr(self, f"inter_conv{lvl}", IConv(c, pred_in))
            setattr(self, f"predict_flow{lvl}", PlainConv(pred_in, 2))
            if dec is None:
                break
            setattr(self, f"upsampled_flow{lvl}_to_{lvl - 1}",
                    Deconv(2, 2, bias=up_bias))
            setattr(self, f"deconv{lvl - 1}", _Deconv(c, dec))
            c = skip + dec + 2

    def _tail(self, out3: torch.Tensor, skip2: torch.Tensor) -> torch.Tensor:
        """conv4 … conv6_1 from the ÷8 features, then the decoder with the
        skips out5, out4, out3 and `skip2` (÷4): the ÷4 flow."""
        out4 = self.conv4_1(self.conv4(out3))
        out5 = self.conv5_1(self.conv5(out4))
        x = self.conv6_1(self.conv6(out5))
        for lvl, skip in zip((6, 5, 4, 3), (out5, out4, out3, skip2)):
            pred_in = x
            if self.inter and lvl < 6:
                pred_in = getattr(self, f"inter_conv{lvl}")(x)
            flow = getattr(self, f"predict_flow{lvl}")(pred_in)
            flow_up = getattr(self, f"upsampled_flow{lvl}_to_{lvl - 1}")(
                flow)
            x = torch.cat([skip, getattr(self, f"deconv{lvl - 1}")(x),
                           flow_up], dim=1)
        if self.inter:
            x = self.inter_conv2(x)
        return self.predict_flow2(x)


class FlowNetC(_CascadeNet):
    """`FlowNetC.py` (batchNorm=False): a 6-channel stacked pair in (NCHW),
    the ÷4 flow out (NCHW)."""

    def __init__(self):
        super().__init__()
        self.conv1 = CL(3, 64, 7, 2)
        self.conv2 = CL(64, 128, 5, 2)
        self.conv3 = CL(128, 256, 5, 2)
        self.conv_redir = CL(256, 32, 1, 1)
        self.conv3_1 = CL(473, 256)
        self._add_tail(up_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = x[:, :3], x[:, 3:]
        c2a = self.conv2(self.conv1(x1))
        c3a = self.conv3(c2a)
        c3b = self.conv3(self.conv2(self.conv1(x2)))
        corr = local_corr(c3a.permute(0, 2, 3, 1).contiguous(),
                          c3b.permute(0, 2, 3, 1).contiguous(), 21, 2)
        corr = _leaky(corr).permute(0, 3, 1, 2)
        return self._tail(self.conv3_1(torch.cat([self.conv_redir(c3a),
                                                  corr], dim=1)), c2a)


class FlowNetS(_CascadeNet):
    """`FlowNetS.py` (batchNorm=False), 12 channels in the cascade; its
    flow upsamplers have no bias."""

    def __init__(self):
        super().__init__()
        self.conv1 = CL(12, 64, 7, 2)
        self.conv2 = CL(64, 128, 5, 2)
        self.conv3 = CL(128, 256, 5, 2)
        self.conv3_1 = CL(256, 256)
        self._add_tail(up_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out2 = self.conv2(self.conv1(x))
        return self._tail(self.conv3_1(self.conv3(out2)), out2)


class FlowNetSD(_CascadeNet):
    """`FlowNetSD.py` (batchNorm=False), 6 channels in; an `i_conv` before
    each prediction but the first."""

    def __init__(self):
        super().__init__()
        self.conv0 = CL(6, 64)
        self.conv1 = CL(64, 64, 3, 2)
        self.conv1_1 = CL(64, 128)
        self.conv2 = CL(128, 128, 3, 2)
        self.conv2_1 = CL(128, 128)
        self.conv3 = CL(128, 256, 3, 2)
        self.conv3_1 = CL(256, 256)
        self._add_tail(up_bias=True, inter=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv1_1(self.conv1(self.conv0(x)))
        out2 = self.conv2_1(self.conv2(out1))
        return self._tail(self.conv3_1(self.conv3(out2)), out2)


class FlowNetFusion(nn.Module):
    """`FlowNetFusion.py` (batchNorm=False), 11 channels in, the full
    resolution flow out."""

    def __init__(self):
        super().__init__()
        self.conv0 = CL(11, 64)
        self.conv1 = CL(64, 64, 3, 2)
        self.conv1_1 = CL(64, 128)
        self.conv2 = CL(128, 128, 3, 2)
        self.conv2_1 = CL(128, 128)
        self.deconv1 = _Deconv(128, 32)
        self.deconv0 = _Deconv(162, 16)
        self.inter_conv1 = IConv(162, 32)
        self.inter_conv0 = IConv(82, 16)
        self.predict_flow2 = PlainConv(128, 2)
        self.predict_flow1 = PlainConv(32, 2)
        self.predict_flow0 = PlainConv(16, 2)
        self.upsampled_flow2_to_1 = Deconv(2, 2)
        self.upsampled_flow1_to_0 = Deconv(2, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out0 = self.conv0(x)
        out1 = self.conv1_1(self.conv1(out0))
        out2 = self.conv2_1(self.conv2(out1))
        flow2 = self.predict_flow2(out2)
        concat1 = torch.cat([out1, self.deconv1(out2),
                             self.upsampled_flow2_to_1(flow2)], dim=1)
        flow1 = self.predict_flow1(self.inter_conv1(concat1))
        concat0 = torch.cat([out0, self.deconv0(concat1),
                             self.upsampled_flow1_to_0(flow1)], dim=1)
        return self.predict_flow0(self.inter_conv0(concat0))


class FlowNet2(nn.Module):
    """`FlowNet2.py` (fp16=False, rgb_max=255, batchNorm=False, div_flow
    20), eval mode, on unit-range images."""

    def __init__(self):
        super().__init__()
        self.flownetc = FlowNetC()
        self.flownets_1 = FlowNetS()
        self.flownets_2 = FlowNetS()
        self.flownets_d = FlowNetSD()
        self.flownetfusion = FlowNetFusion()

    def forward(self, image1: torch.Tensor,
                image2: torch.Tensor) -> torch.Tensor:
        mean = torch.stack([image1, image2], dim=1).mean(dim=(1, 2, 3),
                                                         keepdim=True)[:, 0]
        x1, x2 = image1 - mean, image2 - mean
        x = torch.cat([x1, x2], dim=-1)
        nchw = x.permute(0, 3, 1, 2)

        def up4(flow):
            H, W = flow.shape[1:3]
            return interpolate_bilinear(flow * DIV_FLOW, (4 * H, 4 * W))

        def warp_inputs(flow):
            warped = resample2d(x2, flow)
            return torch.cat([x, warped, flow / DIV_FLOW,
                              channel_norm(x1 - warped)], dim=-1)

        flow_c = up4(_flow_out(self.flownetc(nchw)))
        concat1 = warp_inputs(flow_c).permute(0, 3, 1, 2)
        flow_s1 = up4(_flow_out(self.flownets_1(concat1)))
        concat2 = warp_inputs(flow_s1).permute(0, 3, 1, 2)

        flow_s2 = upsample_nearest4(_flow_out(self.flownets_2(concat2))
                                    * DIV_FLOW)
        diff_s2 = channel_norm(x1 - resample2d(x2, flow_s2))
        flow_sd = upsample_nearest4(_flow_out(self.flownets_d(nchw))
                                    / DIV_FLOW)
        diff_sd = channel_norm(x1 - resample2d(x2, flow_sd))
        concat3 = torch.cat([x1, flow_sd, flow_s2, channel_norm(flow_sd),
                             channel_norm(flow_s2), diff_sd, diff_s2],
                            dim=-1)
        return _flow_out(self.flownetfusion(concat3.permute(0, 3, 1, 2)))
