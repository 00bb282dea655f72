"""RAFT-small (`pcfa_tpu/models/raft_small.py`) as `nn.Module`s.

Unit-range (B, H, W, 3) images in, (flow_lr, flow_up) out, both
(B, ·, ·, 2) float32. Inside, the networks run NCHW. RAFT's loop with
smaller parts:
* `SmallEncoder`s (bottleneck blocks): fnet (instance norm, 128 channels)
  on both frames in one batch, cnet (no norm) on the first, split into
  tanh(net) (96) and relu(inp) (64); every conv is `F.conv2d`, as the JAX
  package leaves them to XLA;
* the materialized correlation pyramid (4 levels) and the radius-3 window
  lookup (`corr_lookup_window`: the CUDA kernel on the card), 196 channels;
  the JAX model has no other corr path, so neither has this one;
* `SmallUpdateBlock`: motion encoder, a single 3×3 `ConvGRU` and the flow
  head; no upsampling mask: `flow_up` is `upflow(flow_lr, 8)`, bilinear
  with align_corners=True;
* `coords1` detached at every iteration; `remat` / `remat_policy` as RAFT
  (`models/raft.refine`); coords and flow stay float32, corr features and
  the flow entering the motion encoder take the network's dtype.
Module names follow the reference torch RAFT (small=True) `state_dict`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pcfa_tpu_torch.models.layers import SmallEncoder
from pcfa_tpu_torch.models.raft import FlowHead, refine
from pcfa_tpu_torch.ops.correlation import (
    corr_lookup_window,
    corr_pyramid_pooled,
)
from pcfa_tpu_torch.ops.warp import coords_grid, upflow


class ConvGRU(nn.Module):
    """One 3×3 GRU pass."""

    def __init__(self, hidden_dim: int = 96, input_dim: int = 146):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz = nn.Conv2d(c, hidden_dim, 3, padding=1)
        self.convr = nn.Conv2d(c, hidden_dim, 3, padding=1)
        self.convq = nn.Conv2d(c, hidden_dim, 3, padding=1)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class SmallMotionEncoder(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 3):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = nn.Conv2d(cor_planes, 96, 1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 32, 3, padding=1)
        self.conv = nn.Conv2d(128, 80, 3, padding=1)

    def forward(self, flow, corr):
        cor = torch.relu(self.convc1(corr))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SmallUpdateBlock(nn.Module):
    def __init__(self, hidden_dim: int = 96, corr_levels: int = 4,
                 corr_radius: int = 3):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_levels, corr_radius)
        self.gru = ConvGRU(hidden_dim, 82 + 64)
        self.flow_head = FlowHead(hidden_dim, 128)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.flow_head(net)


class RAFTSmall(nn.Module):
    """RAFT small=True: hidden 96, context 64, radius 3, 4 levels, 12
    refinement iterations by default."""

    def __init__(self, iters: int = 12, corr_levels: int = 4,
                 corr_radius: int = 3, hidden_dim: int = 96,
                 context_dim: int = 64, remat: bool = False,
                 remat_policy: str | None = None):
        super().__init__()
        if remat and remat_policy not in (None, "dots"):
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        self.iters = iters
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.hidden_dim = hidden_dim
        self.remat = remat
        self.remat_policy = remat_policy
        self.fnet = SmallEncoder(128, "instance")
        self.cnet = SmallEncoder(hidden_dim + context_dim, "none")
        self.update_block = SmallUpdateBlock(hidden_dim, corr_levels,
                                             corr_radius)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor):
        x1 = (2.0 * image1 - 1.0).permute(0, 3, 1, 2)
        x2 = (2.0 * image2 - 1.0).permute(0, 3, 1, 2)

        fmaps = self.fnet(torch.cat([x1, x2], dim=0)).permute(0, 2, 3, 1)
        fmap1, fmap2 = fmaps.chunk(2, dim=0)
        pyramid = corr_pyramid_pooled(fmap1, fmap2, self.corr_levels)

        cnet = self.cnet(x1)
        net, inp = torch.split(cnet, [self.hidden_dim,
                                      cnet.shape[1] - self.hidden_dim], dim=1)
        net = torch.tanh(net)
        inp = torch.relu(inp)

        # the JAX model adds 0·net to its initial coords1, which only types
        # the scan carry under shard_map; there is nothing to type here
        B, _, H8, W8 = net.shape
        coords0 = coords_grid(B, H8, W8, device=net.device)

        def step(net, coords1):
            corr = corr_lookup_window(pyramid, coords1, self.corr_radius)
            corr = corr.to(net.dtype).permute(0, 3, 1, 2)
            flow = (coords1 - coords0).to(net.dtype).permute(0, 3, 1, 2)
            net, delta_flow = self.update_block(net, inp, corr, flow)
            return net, coords1 + delta_flow.permute(0, 2, 3, 1)

        net, coords1 = refine(step, net, coords0, self.iters, self.remat,
                              self.remat_policy)
        flow_lr = coords1 - coords0
        return flow_lr, upflow(flow_lr, 8, align_corners=True)
