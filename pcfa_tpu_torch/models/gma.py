"""GMA, RAFT with global motion aggregation (`pcfa_tpu/models/gma.py`), as
`nn.Module`s.

RAFT's encoders, correlation paths, GRU, flow head and convex upsampler,
plus:
* `Attention`: a 1×1 conv without bias gives Q and K from the context
  features; softmax(Q·Kᵀ/√d) over all H/8·W/8 positions, computed once per
  forward and reused by every iteration. `position_only` /
  `position_and_content` replace / add the decomposed relative-position
  scores of `RelPosEmb`;
* `Aggregate`: V from the motion features, the attention-weighted sum, a
  1×1 `project` when dim ≠ heads·dim_head, and the residual gain `gamma`
  (initialised to 0);
* the update block's GRU reads [inp, motion, motion_global] (384 channels
  beside the 128 hidden ones).
6 refinement iterations by default. The attention stays `torch.matmul` +
`torch.softmax` (the matrix itself is what the iterations reuse). Module
names follow the reference torch GMA's `state_dict` keys; `att.pos_emb`
exists only in the positional variants.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pcfa_tpu_torch.models.raft import RAFT, BasicUpdateBlock
from pcfa_tpu_torch.parallel.mesh import Mesh, gather_rows, reduce_grad


class RelPosEmb(nn.Module):
    """Decomposed relative-position scores: for a query at (x, y) and a key
    at (u, v), ⟨q, rel_height[u − x]⟩ + ⟨q, rel_width[v − y]⟩, with offsets
    stored from −(max_pos_size − 1)."""

    def __init__(self, max_pos_size: int = 160, dim_head: int = 128):
        super().__init__()
        self.max_pos_size = max_pos_size
        self.rel_height = nn.Embedding(2 * max_pos_size - 1, dim_head)
        self.rel_width = nn.Embedding(2 * max_pos_size - 1, dim_head)

    def _table(self, emb: nn.Embedding, size: int) -> torch.Tensor:
        i = torch.arange(size, device=emb.weight.device)
        return emb.weight[i[None, :] - i[:, None] + self.max_pos_size - 1]

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        """q: (B, heads, H, W, d), already scaled → (B, heads, H, W, H, W)."""
        _, _, H, W, _ = q.shape
        h_score = torch.einsum("bhxyd,xud->bhxyu", q,
                               self._table(self.rel_height, H))
        w_score = torch.einsum("bhxyd,yvd->bhxyv", q,
                               self._table(self.rel_width, W))
        return h_score[..., :, None] + w_score[..., None, :]


class Attention(nn.Module):
    """Softmax attention of every position over all positions of a (B, C,
    H, W) map → (B, heads, H·W, H·W)."""

    def __init__(self, dim: int = 128, heads: int = 1, dim_head: int = 128,
                 max_pos_size: int = 160, position_only: bool = False,
                 position_and_content: bool = False):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.position_only = position_only
        self.position_and_content = position_and_content
        self.to_qk = nn.Conv2d(dim, 2 * heads * dim_head, 1, bias=False)
        if position_only or position_and_content:
            self.pos_emb = RelPosEmb(max_pos_size, dim_head)

    def forward(self, fmap: torch.Tensor,
                rows: tuple[int, int] | None = None) -> torch.Tensor:
        """`rows` (start, stop): only the queries of those rows of the map
        (row sharding, `parallel/sp.py`) → (B, heads, rows·W, H·W)."""
        B, _, H, W = fmap.shape
        q, k = self.to_qk(fmap).chunk(2, dim=1)
        # (B, heads·d, H, W) → (B, heads, H·W, d)
        q, k = (t.reshape(B, self.heads, self.dim_head, H * W)
                .transpose(-1, -2) for t in (q, k))
        if rows is not None:
            if self.position_only or self.position_and_content:
                raise NotImplementedError(
                    "spatial sharding of the positional-attention variants "
                    "is not implemented (dead weights in the shipped config)")
            q = q[:, :, rows[0] * W:rows[1] * W]
        q = q * self.dim_head ** -0.5
        if self.position_only or self.position_and_content:
            sim_pos = self.pos_emb(q.reshape(B, self.heads, H, W, -1))
            sim_pos = sim_pos.reshape(B, self.heads, H * W, H * W)
        if self.position_only:
            sim = sim_pos
        else:
            sim = torch.matmul(q, k.transpose(-1, -2))
            if self.position_and_content:
                sim = sim + sim_pos
        return torch.softmax(sim, dim=-1)


class Aggregate(nn.Module):
    """fmap + γ · (attention-weighted sum of V = to_v(fmap)), with a 1×1
    `project` when dim ≠ heads·dim_head. NCHW in and out."""

    def __init__(self, dim: int = 128, heads: int = 1, dim_head: int = 128):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_v = nn.Conv2d(dim, inner, 1, bias=False)
        if dim != inner:
            self.project = nn.Conv2d(inner, dim, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attn: torch.Tensor, fmap: torch.Tensor,
                mesh: Mesh | None = None) -> torch.Tensor:
        """`mesh`: `attn` holds this rank's query rows; the aggregate of
        every row is all-gathered."""
        B, _, H, W = fmap.shape
        v = self.to_v(fmap).reshape(B, self.heads, self.dim_head, H * W)
        if mesh is not None:
            v = reduce_grad(v, mesh)
        out = torch.matmul(attn, v.transpose(-1, -2))  # (B, heads, HW, d)
        if mesh is not None:
            out = gather_rows(out, mesh, 2)
        out = out.transpose(-1, -2).reshape(B, -1, H, W)
        if hasattr(self, "project"):
            out = self.project(out)
        return fmap + self.gamma * out


class GMAUpdateBlock(BasicUpdateBlock):
    """RAFT's update block with `aggregator`: the GRU reads [inp, motion,
    aggregated motion]."""

    def __init__(self, hidden_dim: int = 128, corr_levels: int = 4,
                 corr_radius: int = 4, heads: int = 1):
        super().__init__(hidden_dim, corr_levels, corr_radius,
                         gru_input_dim=128 + 2 * hidden_dim)
        self.aggregator = Aggregate(128, heads, 128)

    def forward(self, net, inp, corr, flow, attention, mesh=None,
                gates=None):
        motion = self.encoder(flow, corr)
        motion_global = self.aggregator(attention, motion, mesh)
        net = self.gru(net, torch.cat([inp, motion, motion_global], dim=1),
                       gates)
        return net, self.flow_head(net)


class GMA(RAFT):
    """RAFT-GMA (6 refinement iterations by default). The shipped config
    is content-only attention with one head. `corr_impl`, `corr_block`,
    `remat`, `remat_policy` and `spatial_shards` as RAFT's; under row
    sharding each rank keeps its query rows of the attention."""

    def __init__(self, iters: int = 6, corr_levels: int = 4,
                 corr_radius: int = 4, hidden_dim: int = 128,
                 context_dim: int = 128, num_heads: int = 1,
                 position_only: bool = False,
                 position_and_content: bool = False, corr_impl: str = "auto",
                 corr_block: int = 1024, remat: bool = False,
                 remat_policy: str | None = None, spatial_shards: int = 1):
        super().__init__(iters, corr_levels, corr_radius, hidden_dim,
                         context_dim, corr_impl, corr_block, remat,
                         remat_policy, spatial_shards)
        self.update_block = GMAUpdateBlock(hidden_dim, corr_levels,
                                           corr_radius, num_heads)
        self.att = Attention(context_dim, num_heads, context_dim,
                             position_only=position_only,
                             position_and_content=position_and_content)

    def update_context(self, inp: torch.Tensor,
                       mesh: Mesh | None = None) -> tuple:
        """(attention, mesh): under row sharding this rank's query rows of
        the attention, from the context features through f."""
        if mesh is None:
            return self.att(inp), None
        rows = mesh.rows(inp.shape[2])
        return self.att(reduce_grad(inp, mesh), rows), mesh
