"""RAFT (`pcfa_tpu/models/raft.py`) as `nn.Module`s.

Unit-range (B, H, W, 3) images in, (flow_lr, flow_up) out, both
(B, ·, ·, 2) float32. Inside, the networks run NCHW. Semantics kept from
the JAX package:
* inputs mapped to [-1, 1]; fnet (instance norm) runs on both frames in
  one batch, cnet (batch norm) on the first, split into tanh(net) and
  relu(inp);
* correlation pyramid of ⟨f1, f2⟩/√C over pooled f2 (4 levels), radius-4
  window lookup with the reference's transposed window offsets;
* the refinement is a Python loop, and `coords1` is detached at every
  iteration (reference raft.py:123);
* coords and flow stay float32; corr features and the flow entering the
  motion encoder take the network's dtype;
* the upsampling-mask head runs once, on the final GRU state;
* convex 8× upsampling with 0.25-scaled mask logits.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pcfa_tpu_torch.models.layers import BasicEncoder
from pcfa_tpu_torch.ops.correlation import (
    corr_lookup_window,
    corr_pyramid_pooled,
    resolve_corr_impl,
)
from pcfa_tpu_torch.ops.warp import coords_grid


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


class SepConvGRU(nn.Module):
    """Horizontal (1×5) then vertical (5×1) GRU passes."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        c = hidden_dim + input_dim
        for suffix, k, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{suffix}",
                        nn.Conv2d(c, hidden_dim, k, padding=pad))

    def forward(self, h, x):
        for suffix in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
            q = torch.tanh(getattr(self, f"convq{suffix}")(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicUpdateBlock(nn.Module):
    """Motion encoder → SepConvGRU → flow head; `mask` is the upsampling
    head (conv, ReLU, conv), applied once after the loop."""

    def __init__(self, hidden_dim: int = 128, corr_levels: int = 4,
                 corr_radius: int = 4):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(
            nn.Conv2d(hidden_dim, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.flow_head(net)


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor,
                         factor: int = 8) -> torch.Tensor:
    """Convex-combination upsampling, NHWC. flow (B, H, W, 2); mask
    (B, H, W, 9·factor²) with channel order (k·factor + i)·factor + j.
    Computed in the wider of the two dtypes (flow is float32)."""
    B, H, W, _ = flow.shape
    f = factor
    out_dtype = torch.promote_types(mask.dtype, flow.dtype)
    mask = torch.softmax(mask.reshape(B, H, W, 9, f, f).to(out_dtype), dim=3)
    fp = nn.functional.pad((f * flow).permute(0, 3, 1, 2), (1, 1, 1, 1))
    fp = fp.permute(0, 2, 3, 1).to(out_dtype)
    neighbors = torch.stack([fp[:, dy:dy + H, dx:dx + W]
                             for dy in range(3) for dx in range(3)], dim=3)
    up = torch.sum(mask[..., None] * neighbors[:, :, :, :, None, None, :],
                   dim=3)                      # (B, H, W, i, j, 2)
    up = up.permute(0, 1, 3, 2, 4, 5)          # (B, H, i, W, j, 2)
    return up.reshape(B, f * H, f * W, 2)


class RAFT(nn.Module):
    """Full-size RAFT (12 refinement iterations by default)."""

    def __init__(self, iters: int = 12, corr_levels: int = 4,
                 corr_radius: int = 4, hidden_dim: int = 128,
                 context_dim: int = 128, corr_impl: str = "auto"):
        super().__init__()
        self.iters = iters
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.hidden_dim = hidden_dim
        self.corr_impl = corr_impl
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(hidden_dim + context_dim, "batch")
        self.update_block = BasicUpdateBlock(hidden_dim, corr_levels,
                                             corr_radius)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor):
        x1 = (2.0 * image1 - 1.0).permute(0, 3, 1, 2)
        x2 = (2.0 * image2 - 1.0).permute(0, 3, 1, 2)

        fmaps = self.fnet(torch.cat([x1, x2], dim=0)).permute(0, 2, 3, 1)
        fmap1, fmap2 = fmaps.chunk(2, dim=0)
        resolve_corr_impl(self.corr_impl, fmap1.shape, fmap2.shape,
                          self.corr_levels, fmap1.dtype)
        pyramid = corr_pyramid_pooled(fmap1, fmap2, self.corr_levels)

        cnet = self.cnet(x1)
        net, inp = torch.split(cnet, [self.hidden_dim,
                                      cnet.shape[1] - self.hidden_dim], dim=1)
        net = torch.tanh(net)
        inp = torch.relu(inp)

        B, _, H8, W8 = net.shape
        coords0 = coords_grid(B, H8, W8, device=net.device)
        coords1 = coords0
        for _ in range(self.iters):
            coords1 = coords1.detach()  # reference raft.py:123
            corr = corr_lookup_window(pyramid, coords1, self.corr_radius)
            flow = coords1 - coords0
            corr = corr.to(net.dtype).permute(0, 3, 1, 2)
            flow = flow.to(net.dtype).permute(0, 3, 1, 2)
            net, delta_flow = self.update_block(net, inp, corr, flow)
            coords1 = coords1 + delta_flow.permute(0, 2, 3, 1)
        up_mask = 0.25 * self.update_block.mask(net)

        flow_lr = coords1 - coords0
        flow_up = upsample_flow_convex(flow_lr, up_mask.permute(0, 2, 3, 1))
        return flow_lr, flow_up
