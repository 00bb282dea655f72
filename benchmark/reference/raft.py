"""RAFT in plain float32 PyTorch: the yardstick of the RAFT cells.

After Teed & Deng, "RAFT: Recurrent All-Pairs Field Transforms for Optical
Flow", ECCV 2020, and princeton-vl/RAFT `core/{raft,extractor,update,
corr}.py`: module names and state-dict keys are the published ones, so
`load_state_dict` reads a published checkpoint's keys (less the
`module.` prefix), BatchNorm statistics included. Departures, none of
which changes the output:
* inputs are unit-range (B, H, W, 3) and the flow comes back as
  (B, H, W, 2): the published model takes [0, 255] NCHW;
* the upsampling mask is computed once, from the final hidden state (the
  published loop computes it every iteration and uses the last);
* the shortcut norm of a strided residual block lives only in
  `downsample.1` (the published block also registers it as `norm3`,
  the same module under a second key).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.common import Conv2d, matmul


def _norm(kind: str, c: int) -> nn.Module:
    return nn.BatchNorm2d(c) if kind == "batch" else nn.InstanceNorm2d(c)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn, stride=1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride),
                _norm(norm_fn, planes))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim=128, norm_fn="batch"):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm_fn, 64)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm_fn),
                                    ResidualBlock(64, 64, norm_fn))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm_fn, 2),
                                    ResidualBlock(96, 96, norm_fn))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm_fn, 2),
                                    ResidualBlock(128, 128, norm_fn))
        self.conv2 = Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_levels, corr_radius):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = Conv2d(cor_planes, 256, 1)
        self.convc2 = Conv2d(256, 192, 3, padding=1)
        self.convf1 = Conv2d(2, 128, 7, padding=3)
        self.convf2 = Conv2d(128, 64, 3, padding=1)
        self.conv = Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim=128, input_dim=192 + 128):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz1 = Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convr1 = Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convq1 = Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convz2 = Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convr2 = Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convq2 = Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))

    def forward(self, h, x):
        for z_conv, r_conv, q_conv in (
                (self.convz1, self.convr1, self.convq1),
                (self.convz2, self.convr2, self.convq2)):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(z_conv(hx))
            r = torch.sigmoid(r_conv(hx))
            q = torch.tanh(q_conv(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_levels, corr_radius, hidden_dim=128,
                 input_dim=128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru = SepConvGRU(hidden_dim, input_dim + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(Conv2d(128, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.flow_head(net)


def coords_grid(batch, ht, wd, device, dtype=torch.float32):
    y, x = torch.meshgrid(torch.arange(ht, device=device),
                          torch.arange(wd, device=device), indexing="ij")
    return torch.stack([x, y], dim=0).to(dtype)[None].repeat(batch, 1, 1, 1)


def bilinear_sampler(img, coords):
    """grid_sample at pixel coordinates, align_corners=True, zero padding."""
    H, W = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    xgrid = 2 * xgrid / (W - 1) - 1
    ygrid = 2 * ygrid / (H - 1) - 1
    return F.grid_sample(img, torch.cat([xgrid, ygrid], dim=-1),
                         align_corners=True)


class CorrBlock:
    """All-pairs correlation ⟨f1, f2⟩/√C, average-pooled over f2 into
    `num_levels` levels, read in (2r+1)² windows. The window offsets are
    the published ones: `meshgrid(dy, dx)` stacked as the (x, y) offset,
    so the window's first axis moves x."""

    def __init__(self, fmap1, fmap2, num_levels, radius, precision):
        self.num_levels, self.radius = num_levels, radius
        batch, dim, ht, wd = fmap1.shape
        corr = matmul(fmap1.view(batch, dim, ht * wd).transpose(1, 2),
                      fmap2.view(batch, dim, ht * wd), precision)
        corr = corr.view(batch * ht * wd, 1, ht, wd) / dim ** 0.5
        self.pyramid = [corr]
        for _ in range(num_levels - 1):
            corr = F.avg_pool2d(corr, 2, stride=2)
            self.pyramid.append(corr)

    def __call__(self, coords):
        r = self.radius
        coords = coords.permute(0, 2, 3, 1)
        batch, h1, w1, _ = coords.shape
        out = []
        for i, corr in enumerate(self.pyramid):
            dx = torch.linspace(-r, r, 2 * r + 1, device=coords.device,
                                dtype=coords.dtype)
            dy = torch.linspace(-r, r, 2 * r + 1, device=coords.device,
                                dtype=coords.dtype)
            delta = torch.stack(torch.meshgrid(dy, dx, indexing="ij"), -1)
            centroid = coords.reshape(batch * h1 * w1, 1, 1, 2) / 2 ** i
            sampled = bilinear_sampler(corr, centroid + delta.view(
                1, 2 * r + 1, 2 * r + 1, 2))
            out.append(sampled.view(batch, h1, w1, -1))
        return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous()


def upsample_flow(flow, mask):
    """Convex 8× upsampling of (B, 2, H, W) with (B, 576, H, W) logits."""
    N, _, H, W = flow.shape
    mask = torch.softmax(mask.view(N, 1, 9, 8, 8, H, W), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(N, 2, 9, 1, 1, H, W)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(N, 2, 8 * H, 8 * W)


class RAFT(nn.Module):
    precision = "float32"

    def __init__(self, iters=12, corr_levels=4, corr_radius=4,
                 hidden_dim=128, context_dim=128):
        super().__init__()
        self.iters, self.hidden_dim = iters, hidden_dim
        self.context_dim = context_dim
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(hidden_dim + context_dim, "batch")
        self.update_block = BasicUpdateBlock(corr_levels, corr_radius,
                                             hidden_dim, context_dim)

    def forward(self, image1, image2):
        """Unit-range (B, H, W, 3) pair (H, W divisible by 8) → flow
        (B, H, W, 2)."""
        x1 = (2 * image1 - 1).permute(0, 3, 1, 2)
        x2 = (2 * image2 - 1).permute(0, 3, 1, 2)
        fmap1, fmap2 = self.fnet(torch.cat([x1, x2])).chunk(2)
        # at least float32, as the published `fmap1.float()`
        wide = torch.promote_types(fmap1.dtype, torch.float32)
        corr_fn = CorrBlock(fmap1.to(wide), fmap2.to(wide), self.corr_levels,
                            self.corr_radius, self.precision)
        net, inp = torch.split(self.cnet(x1), [self.hidden_dim,
                                               self.context_dim], dim=1)
        net, inp = torch.tanh(net), torch.relu(inp)
        N, _, H, W = x1.shape
        coords0 = coords_grid(N, H // 8, W // 8, x1.device, wide)
        coords1 = coords0.clone()
        for _ in range(self.iters):
            coords1 = coords1.detach()
            corr = corr_fn(coords1)
            net, delta_flow = self.update_block(net, inp, corr,
                                                coords1 - coords0)
            coords1 = coords1 + delta_flow
        up_mask = 0.25 * self.update_block.mask(net)
        return upsample_flow(coords1 - coords0, up_mask).permute(0, 2, 3, 1)
