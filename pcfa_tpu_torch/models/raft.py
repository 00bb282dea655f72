"""RAFT (`pcfa_tpu/models/raft.py`) as `nn.Module`s.

Unit-range (B, H, W, 3) images in, (flow_lr, flow_up) out, both
(B, ·, ·, 2) float32. Inside, the networks run NCHW. Semantics kept from
the JAX package:
* inputs mapped to [-1, 1]; fnet (instance norm) runs on both frames in
  one batch, cnet (batch norm) on the first, split into tanh(net) and
  relu(inp);
* correlation pyramid of ⟨f1, f2⟩/√C over pooled f2 (4 levels), radius-4
  window lookup with the reference's transposed window offsets; the
  'fused' and 'hybrid' paths rebuild the rows blockwise per lookup
  (`corr_impl`, resolved per shape by `resolve_corr_impl`);
* the refinement is a Python loop, and `coords1` is detached at every
  iteration (reference raft.py:123); `remat=True` runs each iteration
  (lookup and update block) under a non-reentrant checkpoint;
* coords and flow stay float32; corr features and the flow entering the
  motion encoder take the network's dtype;
* the upsampling-mask head runs once, on the final GRU state;
* convex 8× upsampling with 0.25-scaled mask logits;
* `spatial_shards` > 1 splits the pyramid (and GMA's attention) by rows
  over the ranks of the 'space' mesh (`parallel/sp.py`).
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from pcfa_tpu_torch.config import gru_fused
from pcfa_tpu_torch.models.layers import BasicEncoder
from pcfa_tpu_torch.ops.correlation import make_corr_lookup, resolve_corr_impl
from pcfa_tpu_torch.ops.warp import coords_grid
from pcfa_tpu_torch.parallel.mesh import Mesh, gather_rows, reduce_grad
from pcfa_tpu_torch.utils import profiling

# the matrix products and convolutions 'dots' keeps: everything else in
# an iteration is recomputed in the backward
_PRODUCTS = frozenset({
    torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
    torch.ops.aten.convolution.default})


def _save_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def refine(step: Callable, net: torch.Tensor, coords1: torch.Tensor,
           iters: int, remat: bool = False,
           remat_policy: str | None = None):
    """`iters` refinement iterations `net, coords1 = step(net, coords1)`,
    coords1 detached before each (reference raft.py:123). With `remat`
    (and autograd recording) each iteration runs under a non-reentrant
    `torch.utils.checkpoint`: the backward recomputes it, and under 'dots'
    only its non-product ops. Remat changes memory, not values. The
    pyramid is built before, outside the checkpoints, so a recomputed
    lookup adds into the same gradient buffers as the first."""
    kw = dict(use_reentrant=False)
    if remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_products)
    for _ in range(iters):
        coords1 = coords1.detach()
        if remat and torch.is_grad_enabled():
            net, coords1 = checkpoint(step, net, coords1, **kw)
        else:
            net, coords1 = step(net, coords1)
    return net, coords1


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


class SepConvGRU(nn.Module):
    """Horizontal (1×5) then vertical (5×1) GRU passes.

    `fused` (None: `config.gru_fused()`, PCFA_GRU_FUSED=1): z and r read
    the same input, so they run as one conv over the output-concatenated
    `convz*`/`convr*` weights, split after; same parameters and names.
    The concatenated weights are loop-invariant: `gate_weights()` builds
    them once per forward and the caller passes them to every call."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256,
                 fused: bool | None = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.fused = fused
        c = hidden_dim + input_dim
        for suffix, k, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{suffix}",
                        nn.Conv2d(c, hidden_dim, k, padding=pad))

    def gate_weights(self) -> dict | None:
        """{suffix: (weight, bias)} of the fused z/r conv per pass, or None
        when the gates run unfused."""
        if not (self.fused if self.fused is not None else gru_fused()):
            return None
        return {suffix: tuple(
            torch.cat([getattr(self, f"convz{suffix}").get_parameter(n),
                       getattr(self, f"convr{suffix}").get_parameter(n)])
            for n in ("weight", "bias")) for suffix in ("1", "2")}

    def forward(self, h, x, gates: dict | None = None):
        if gates is None:
            gates = self.gate_weights()
        for suffix in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            if gates is None:
                z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
                r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
            else:
                conv = getattr(self, f"convz{suffix}")
                zr = F.conv2d(hx, *gates[suffix], padding=conv.padding)
                z, r = torch.sigmoid(zr).split(self.hidden_dim, dim=1)
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
    head (conv, ReLU, conv), applied once after the loop. `gates`: the
    GRU's fused gate weights (`SepConvGRU.gate_weights`)."""

    def __init__(self, hidden_dim: int = 128, corr_levels: int = 4,
                 corr_radius: int = 4, gru_input_dim: int | None = None):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru = SepConvGRU(hidden_dim, gru_input_dim or 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(
            nn.Conv2d(hidden_dim, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow, gates=None):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1), gates)
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
    """Full-size RAFT (12 refinement iterations by default).

    `corr_impl`: 'auto' (per shape, `resolve_corr_impl`), 'materialized',
    'fused' or 'hybrid'; `corr_block` queries per block of the last two.
    `remat` / `remat_policy`: see `refine`; the policies are those of
    `pcfa_tpu/models/raft.py:_remat_body`, None (recompute the whole
    iteration) or 'dots' (keep its products' outputs).
    `spatial_shards`: the ranks of the 'space' mesh (`sp.space_mesh`) the
    pyramid's rows are split over (`parallel/sp.py`); 1 runs whole."""

    def __init__(self, iters: int = 12, corr_levels: int = 4,
                 corr_radius: int = 4, hidden_dim: int = 128,
                 context_dim: int = 128, corr_impl: str = "auto",
                 corr_block: int = 1024, remat: bool = False,
                 remat_policy: str | None = None, spatial_shards: int = 1):
        super().__init__()
        if remat and remat_policy not in (None, "dots"):
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        self.iters = iters
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.hidden_dim = hidden_dim
        self.corr_impl = corr_impl
        self.corr_block = corr_block
        self.remat = remat
        self.remat_policy = remat_policy
        self.spatial_shards = spatial_shards
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(hidden_dim + context_dim, "batch")
        self.update_block = BasicUpdateBlock(hidden_dim, corr_levels,
                                             corr_radius)

    def update_context(self, inp: torch.Tensor,
                       mesh: Mesh | None = None) -> tuple:
        """Loop-invariant inputs of the update block beside `inp` (none
        for RAFT; GMA's attention)."""
        return ()

    def _space_mesh(self) -> Mesh | None:
        """The 'space' mesh the rows are split over; None when whole."""
        if self.spatial_shards == 1:
            return None
        from pcfa_tpu_torch.parallel.sp import space_mesh

        mesh = space_mesh()
        if mesh.size != self.spatial_shards:
            raise ValueError(f"spatial_shards={self.spatial_shards} needs "
                             f"as many ranks; the 'space' mesh has "
                             f"{mesh.size}")
        return mesh

    def graph_capturable(self, shape1: tuple, shape2: tuple,
                         dtype: torch.dtype) -> bool:
        """Whether CUDA graphs can capture this forward and its backward on
        (B, H, W, 3) inputs of these shapes in `dtype` (`utils/graphs.py`
        asks once per input signature): not with `remat` (the backward
        recomputes), not split over ranks (collectives inside the
        forward), and only where the corr path resolves to 'materialized'
        for the encoder's ÷8 maps ('fused' and 'hybrid' checkpoint each
        block of queries)."""
        if self.remat or self.spatial_shards != 1:
            return False
        c = self.fnet.conv2.out_channels

        def fmap(s):  # three stride-2 stages: ⌈H/8⌉ × ⌈W/8⌉
            return (s[0], -(-s[1] // 8), -(-s[2] // 8), c)

        return resolve_corr_impl(self.corr_impl, fmap(shape1), fmap(shape2),
                                 self.corr_levels, dtype) == "materialized"

    def forward(self, image1: torch.Tensor, image2: torch.Tensor):
        """Spans (`utils/profiling.py`): `raft.encoders` (fnet, then cnet
        and its split), `raft.pyramid` (the corr path's set-up),
        `raft.refine` and `raft.upsample`; each forward counts as
        `raft.corr_impl.<the resolved path>`."""
        x1 = (2.0 * image1 - 1.0).permute(0, 3, 1, 2)
        x2 = (2.0 * image2 - 1.0).permute(0, 3, 1, 2)

        mesh = self._space_mesh()
        with profiling.span("raft.encoders"):
            fmaps = self.fnet(torch.cat([x1, x2], dim=0)).permute(0, 2, 3, 1)
            if mesh is not None:
                fmaps = reduce_grad(fmaps, mesh)
            fmap1, fmap2 = fmaps.chunk(2, dim=0)
        with profiling.span("raft.pyramid"):
            impl = resolve_corr_impl(self.corr_impl, fmap1.shape,
                                     fmap2.shape, self.corr_levels,
                                     fmap1.dtype, self.spatial_shards)
            profiling.count(f"raft.corr_impl.{impl}")
            if mesh is None:
                lookup = make_corr_lookup(impl, fmap1, fmap2,
                                          self.corr_levels, self.corr_radius,
                                          self.corr_block)
            else:
                if impl == "hybrid":
                    raise NotImplementedError(
                        "corr_impl='hybrid' is not supported under spatial "
                        "sharding (use 'materialized' or 'fused')")
                r0, r1 = mesh.rows(fmap1.shape[1])
                rows = make_corr_lookup(impl, fmap1[:, r0:r1], fmap2,
                                        self.corr_levels, self.corr_radius,
                                        self.corr_block)

                def lookup(c):
                    return gather_rows(rows(c[:, r0:r1]), mesh, 1)

        with profiling.span("raft.encoders"):
            cnet = self.cnet(x1)
            net, inp = torch.split(
                cnet, [self.hidden_dim, cnet.shape[1] - self.hidden_dim],
                dim=1)
            net = torch.tanh(net)
            inp = torch.relu(inp)
        context = self.update_context(inp, mesh)
        gates = self.update_block.gru.gate_weights()

        B, _, H8, W8 = net.shape
        coords0 = coords_grid(B, H8, W8, device=net.device)

        def step(net, coords1):
            corr = lookup(coords1).to(net.dtype).permute(0, 3, 1, 2)
            flow = (coords1 - coords0).to(net.dtype).permute(0, 3, 1, 2)
            net, delta_flow = self.update_block(net, inp, corr, flow,
                                                *context, gates=gates)
            return net, coords1 + delta_flow.permute(0, 2, 3, 1)

        with profiling.span("raft.refine"):
            net, coords1 = refine(step, net, coords0, self.iters, self.remat,
                                  self.remat_policy)
        with profiling.span("raft.upsample"):
            up_mask = 0.25 * self.update_block.mask(net)
            flow_lr = coords1 - coords0
            flow_up = upsample_flow_convex(flow_lr,
                                           up_mask.permute(0, 2, 3, 1))
        return flow_lr, flow_up
