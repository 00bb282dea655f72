"""PWC-DC Net in plain float32 PyTorch: the yardstick of the PWCNet cells.

After Sun et al., "PWC-Net: CNNs for Optical Flow Using Pyramid, Warping,
and Cost Volume", CVPR 2018, and NVlabs/PWC-Net `PyTorch/models/PWCNet.py`
(`PWCDCNet`, md = 4), as the PCFA attack code wraps it: RGB → BGR on
entry, inputs in [0, 1], patch-9 correlation divided by the channel count
and followed by LeakyReLU(0.1), and the eval output flow2 upsampled 4×
(bilinear, align_corners=False) and scaled by 20. Module names and
state-dict keys are the published ones, `deconv2` included (built, never
used). Departures:
* the warp's validity mask keeps a sample where warping an all-ones map
  gives at least 1e-4, as the attack's copy of the network does (NVlabs'
  file keeps it at 0.9999);
* inputs are unit-range (B, H, W, 3) and the flow comes back as
  (B, H, W, 2).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.common import Conv2d, ConvTranspose2d

MD = 4


def conv(c_in, c_out, stride=1, padding=1, dilation=1):
    return nn.Sequential(Conv2d(c_in, c_out, 3, stride, padding, dilation),
                         nn.LeakyReLU(0.1))


def predict_flow(c_in):
    return Conv2d(c_in, 2, 3, 1, 1)


def deconv(c_in, c_out=2):
    return ConvTranspose2d(c_in, c_out, 4, 2, 1)


def correlate(f1, f2, md=MD):
    """out[b, (dy+md)·(2md+1) + dx+md, y, x] = Σ_c f1[c, y, x] ·
    f2[c, y+dy, x+dx] / C, zero outside the map; then LeakyReLU(0.1)."""
    B, C, H, W = f1.shape
    f2p = F.pad(f2, (md, md, md, md))
    out = torch.stack([(f1 * f2p[:, :, dy:dy + H, dx:dx + W]).sum(1)
                       for dy in range(2 * md + 1)
                       for dx in range(2 * md + 1)], dim=1)
    return F.leaky_relu(out / C, 0.1)


def warp(x, flo):
    """Backward warp of NCHW `x` by `flo`, with the validity mask."""
    B, C, H, W = x.shape
    yy, xx = torch.meshgrid(torch.arange(H, device=x.device),
                            torch.arange(W, device=x.device), indexing="ij")
    grid = torch.stack([xx, yy], 0).float()[None] + flo
    vgrid = torch.stack([2.0 * grid[:, 0] / max(W - 1, 1) - 1.0,
                         2.0 * grid[:, 1] / max(H - 1, 1) - 1.0], dim=-1)
    output = F.grid_sample(x, vgrid, align_corners=False)
    with torch.no_grad():
        mask = F.grid_sample(torch.ones_like(x), vgrid, align_corners=False)
        mask = (mask >= 1e-4).to(x.dtype)
    return output * mask


class PWCDCNet(nn.Module):
    precision = "float32"

    def __init__(self, md=MD):
        super().__init__()
        self.conv1a = conv(3, 16, 2)
        self.conv1aa = conv(16, 16)
        self.conv1b = conv(16, 16)
        self.conv2a = conv(16, 32, 2)
        self.conv2aa = conv(32, 32)
        self.conv2b = conv(32, 32)
        self.conv3a = conv(32, 64, 2)
        self.conv3aa = conv(64, 64)
        self.conv3b = conv(64, 64)
        self.conv4a = conv(64, 96, 2)
        self.conv4aa = conv(96, 96)
        self.conv4b = conv(96, 96)
        self.conv5a = conv(96, 128, 2)
        self.conv5aa = conv(128, 128)
        self.conv5b = conv(128, 128)
        self.conv6aa = conv(128, 196, 2)
        self.conv6a = conv(196, 196)
        self.conv6b = conv(196, 196)
        nd = (2 * md + 1) ** 2
        dd = [128, 256, 352, 416, 448]
        for lvl, od in (("6", nd), ("5", nd + 128 + 4), ("4", nd + 96 + 4),
                        ("3", nd + 64 + 4), ("2", nd + 32 + 4)):
            for i, c_out in enumerate((128, 128, 96, 64, 32)):
                setattr(self, f"conv{lvl}_{i}",
                        conv(od + (dd[i - 1] if i else 0), c_out))
            setattr(self, f"predict_flow{lvl}", predict_flow(od + dd[4]))
            setattr(self, f"deconv{lvl}", deconv(2))
            if lvl != "2":
                setattr(self, f"upfeat{lvl}", deconv(od + dd[4]))
        od = nd + 32 + 4
        self.dc_conv1 = conv(od + dd[4], 128, 1, 1, 1)
        self.dc_conv2 = conv(128, 128, 1, 2, 2)
        self.dc_conv3 = conv(128, 128, 1, 4, 4)
        self.dc_conv4 = conv(128, 96, 1, 8, 8)
        self.dc_conv5 = conv(96, 64, 1, 16, 16)
        self.dc_conv6 = conv(64, 32, 1, 1, 1)
        self.dc_conv7 = predict_flow(32)

    def _decode(self, x, lvl):
        for i in range(5):
            x = torch.cat([getattr(self, f"conv{lvl}_{i}")(x), x], 1)
        return x, getattr(self, f"predict_flow{lvl}")(x)

    def forward(self, image1, image2):
        """Unit-range (B, H, W, 3) pair (H, W divisible by 64) → flow
        (B, H, W, 2)."""
        im1 = image1.flip(-1).permute(0, 3, 1, 2)
        im2 = image2.flip(-1).permute(0, 3, 1, 2)
        c1, c2 = [], []
        for im, feats in ((im1, c1), (im2, c2)):
            x = im
            for lvl in "12345":
                x = getattr(self, f"conv{lvl}b")(getattr(
                    self, f"conv{lvl}aa")(getattr(self, f"conv{lvl}a")(x)))
                feats.append(x)
            feats.append(self.conv6b(self.conv6a(self.conv6aa(x))))

        x, flow = self._decode(correlate(c1[5], c2[5]), "6")
        up_flow, up_feat = self.deconv6(flow), self.upfeat6(x)
        for lvl, scale in (("5", 0.625), ("4", 1.25), ("3", 2.5),
                           ("2", 5.0)):
            f1, f2 = c1[int(lvl) - 1], c2[int(lvl) - 1]
            corr = correlate(f1, warp(f2, up_flow * scale))
            x, flow = self._decode(torch.cat([corr, f1, up_flow, up_feat],
                                             1), lvl)
            if lvl != "2":
                up_flow = getattr(self, f"deconv{lvl}")(flow)
                up_feat = getattr(self, f"upfeat{lvl}")(x)
        x = self.dc_conv4(self.dc_conv3(self.dc_conv2(self.dc_conv1(x))))
        flow2 = flow + self.dc_conv7(self.dc_conv6(self.dc_conv5(x)))
        H, W = flow2.shape[-2:]
        up = F.interpolate(flow2, size=(4 * H, 4 * W), mode="bilinear",
                           align_corners=False)
        return (20.0 * up).permute(0, 2, 3, 1)
