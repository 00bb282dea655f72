"""Correlation ops of `pcfa_tpu/ops/correlation.py`: RAFT's and GMA's
correlation paths, chosen per shape by `resolve_corr_impl`:
'materialized' (the pooled pyramid and the window lookup), 'fused' (the
correlation rows rebuilt blockwise at every lookup, never the volume) and
'hybrid' (level 0 fused, levels 1..L−1 materialized); `make_corr_lookup`
builds one for the refinement loop. The plain patch correlation of PWCNet
(`local_correlation`) and FlowNetC (`global_correlation`) is
`ops.local_corr.local_corr_plain(f1, f2, patch, stride)`: patch 9, stride
1 for the one; patch 2·(max_disp/stride2) + 1, stride `stride2` for the
other.

Layouts follow the JAX package at the public functions: feature maps
(B, H, W, C), coords (B, H1, W1, 2), lookup output (B, H1, W1, L·(2r+1)²).
Pyramid levels are (N, H2ₗ, W2ₗ) with N = B·H1·W1 (the JAX package keeps a
trailing unit channel).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from pcfa_tpu_torch.config import corr_hbm_budget_bytes
from pcfa_tpu_torch.ops.corr_lookup import (
    corr_window,
    corr_window_plain,
    pyramid_with_grad,
)
from pcfa_tpu_torch.ops.warp import avg_pool2d


CORR_IMPLS = ("materialized", "fused", "hybrid")


def resolve_corr_impl(impl: str, fmap1_shape: tuple, fmap2_shape: tuple,
                      num_levels: int, dtype: torch.dtype,
                      spatial_shards: int = 1) -> str:
    """Resolve `corr_impl='auto'` as `pcfa_tpu` does: materialize the
    pyramid while its forward plus cotangent footprint fits
    PCFA_CORR_HBM_BUDGET_MB (default 6 GiB), else the blockwise fused
    lookup; split by rows over `spatial_shards` ranks, one rank holds
    1/spatial_shards of the pyramid. 'materialized', 'fused' and 'hybrid'
    are returned as given."""
    if impl == "auto":
        B, H1, W1, _ = fmap1_shape
        _, H2, W2, _ = fmap2_shape
        pyr_elems, h, w = 0, H2, W2
        for _ in range(num_levels):
            pyr_elems += h * w
            h, w = max(h // 2, 1), max(w // 2, 1)
        est = (2 * B * (H1 * W1 // max(spatial_shards, 1)) * pyr_elems
               * dtype.itemsize)
        return "materialized" if est <= corr_hbm_budget_bytes() else "fused"
    if impl not in CORR_IMPLS:
        raise ValueError(f"corr_impl={impl!r}: expected 'auto' or one of "
                         f"{CORR_IMPLS}")
    return impl


def corr_pyramid_pooled(fmap1: torch.Tensor, fmap2: torch.Tensor,
                        num_levels: int = 4,
                        start_level: int = 0) -> list[torch.Tensor]:
    """Per-level correlation against avg-pooled f2 features:
    level l = f1 · avgpool²ˡ(f2)ᵀ / √C, each (B·H1·W1, H2ₗ, W2ₗ), for l from
    `start_level` (the hybrid path materializes levels ≥ 1 only) to
    `num_levels` − 1. The per-level product stays a `torch.matmul`. Under
    autograd the levels come through `pyramid_with_grad`: every
    `corr_window` on them adds its gradient into one buffer per level for
    the backward pass."""
    B, H1, W1, C = fmap1.shape
    f1 = fmap1.reshape(B, H1 * W1, C)
    inv_sqrt_c = 1.0 / math.sqrt(C)
    pyramid = []
    f2_l = fmap2
    for level in range(num_levels):
        if level:
            f2_l = avg_pool2d(f2_l, 2, 2)
        if level < start_level:
            continue
        _, H2, W2, _ = f2_l.shape
        cmap = torch.matmul(f1, f2_l.reshape(B, H2 * W2, C).transpose(1, 2))
        pyramid.append((cmap * inv_sqrt_c).reshape(B * H1 * W1, H2, W2))
    return pyramid_with_grad(pyramid)


def corr_lookup(pyramid: list[torch.Tensor], coords: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """Plain radius-r window lookup (`bilinear_sampler` per level)."""
    B, H1, W1, _ = coords.shape
    out = corr_window_plain(pyramid, coords.reshape(B * H1 * W1, 2), radius)
    return out.reshape(B, H1, W1, -1)


def corr_lookup_window(pyramid: list[torch.Tensor], coords: torch.Tensor,
                       radius: int = 4) -> torch.Tensor:
    """The lookup RAFT runs: the CUDA kernels for CUDA tensors, the plain
    versions for CPU tensors, both through `corr_lookup._CorrWindow`.
    coords are detached (zero gradient)."""
    B, H1, W1, _ = coords.shape
    out = corr_window(pyramid, coords.reshape(B * H1 * W1, 2), radius)
    return out.reshape(B, H1, W1, -1)


def f2_feature_pyramid(fmap2: torch.Tensor,
                       num_levels: int = 4) -> list[torch.Tensor]:
    """Pooled feature pyramid of the fused path: (B, H2/2ˡ, W2/2ˡ, C) per
    level. Pooling the volume over (H2, W2) commutes with the channel dot
    product, so level l's correlation rows are products against avgpool²ˡ
    of f2."""
    levels = [fmap2]
    for _ in range(num_levels - 1):
        levels.append(avg_pool2d(levels[-1], 2, 2))
    return levels


def _fused_block(radius: int, f1_blk: torch.Tensor, c_blk: torch.Tensor,
                 *f2_levels: torch.Tensor) -> torch.Tensor:
    """One block of queries of `corr_lookup_fused`: features (B, T, C) and
    coords (B, T, 2) against the pooled levels → (B, T, L·(2r+1)²) in the
    features' dtype. As `pcfa_tpu` computes it: the rows f1 · f2ₗᵀ in the
    features' dtype, scaled by 1/√C in float32 and cast back; the window
    as two products with separable hat weights built in float32 and cast
    to the rows' dtype."""
    B, T, C = f1_blk.shape
    P = 2 * radius + 1
    dev = f1_blk.device
    inv_sqrt_c = 1.0 / torch.sqrt(torch.tensor(C, dtype=torch.float32,
                                               device=dev))
    lin = torch.linspace(-radius, radius, P, dtype=torch.float32,
                         device=dev)[:, None]
    c32 = c_blk.to(torch.float32)
    outs = []
    for i, f2_l in enumerate(f2_levels):
        _, H2, W2, _ = f2_l.shape
        f2_t = f2_l.reshape(B, H2 * W2, C).transpose(1, 2)
        rows = torch.matmul(f1_blk, f2_t)                      # (B, T, H2·W2)
        corr = (rows.to(torch.float32) * inv_sqrt_c).to(f1_blk.dtype)
        cl = c32 / 2**i
        sx = cl[..., 0:1, None] + lin                          # (B, T, P, 1)
        sy = cl[..., 1:2, None] + lin
        ix = torch.arange(W2, dtype=torch.float32, device=dev)
        iy = torch.arange(H2, dtype=torch.float32, device=dev)
        wx = torch.relu(1.0 - (sx - ix).abs()).to(corr.dtype)  # (B, T, P, W2)
        wy = torch.relu(1.0 - (sy - iy).abs()).to(corr.dtype)  # (B, T, P, H2)
        tmp = torch.matmul(wy, corr.reshape(B, T, H2, W2))     # (B, T, Pb, W2)
        win = torch.matmul(wx, tmp.transpose(-1, -2))          # (B, T, Pa, Pb)
        outs.append(win.reshape(B, T, P * P))
    return torch.cat(outs, dim=-1)


def corr_lookup_fused(fmap1: torch.Tensor, f2_levels: list[torch.Tensor],
                      coords: torch.Tensor, radius: int = 4,
                      block: int = 1024) -> torch.Tensor:
    """Window lookup that never materializes the correlation volume
    (`pcfa_tpu`'s `corr_lookup_fused`): for each block of `block` queries,
    the B pairs' correlation rows against every pooled level in one batched
    product, then the bilinear window as two batched products. Each block
    runs under a non-reentrant `torch.utils.checkpoint`, so the backward
    recomputes its rows instead of keeping them: live memory is one block's
    B·block·H2·W2 rows, not B·N·H2·W2. The last block holds the remainder
    (the JAX package pads it to a whole block for `lax.map`).

    fmap1: (B, H1, W1, C); f2_levels from `f2_feature_pyramid`; coords
    (B, H1, W1, 2). Returns (B, H1, W1, L·(2r+1)²) in fmap1's dtype, with
    the channel order of `corr_lookup` (x takes the first offset)."""
    B, H1, W1, C = fmap1.shape
    N = H1 * W1
    f1 = fmap1.reshape(B, N, C)
    c = coords.reshape(B, N, 2)
    outs = []
    for s in range(0, N, block):
        args = (radius, f1[:, s:s + block], c[:, s:s + block], *f2_levels)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_fused_block, *args, use_reentrant=False))
        else:
            outs.append(_fused_block(*args))
    return torch.cat(outs, dim=1).reshape(B, H1, W1, -1)


def corr_lookup_hybrid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       pyramid_rest: list[torch.Tensor], coords: torch.Tensor,
                       radius: int = 4, block: int = 1024) -> torch.Tensor:
    """Level 0 rebuilt blockwise per lookup (`corr_lookup_fused` on fmap2
    alone), levels 1..L−1 read from `pyramid_rest`, the materialized
    pyramid from `corr_pyramid_pooled(..., start_level=1)`, through
    `corr_lookup_window` (the lookup kernel on the card). That lookup
    scales level l of the list it is given by 2ˡ, so coords go in halved:
    level l of the list is pyramid level l + 1."""
    lvl0 = corr_lookup_fused(fmap1, [fmap2], coords, radius, block)
    rest = corr_lookup_window(pyramid_rest, coords / 2, radius)
    return torch.cat([lvl0, rest], dim=-1)


def make_corr_lookup(impl: str, fmap1: torch.Tensor, fmap2: torch.Tensor,
                     num_levels: int = 4, radius: int = 4,
                     block: int = 1024) -> Callable[[torch.Tensor],
                                                    torch.Tensor]:
    """Build what `impl` (resolved, see `resolve_corr_impl`) keeps for the
    refinement loop and return its lookup, coords (B, H1, W1, 2) →
    (B, H1, W1, L·(2r+1)²): 'materialized' the pyramid, 'fused' the pooled
    features, 'hybrid' fmap2 and the materialized levels 1..L−1. The
    pyramid is built here, outside any per-iteration checkpoint, so the
    lookups of one forward add into its one set of gradient buffers."""
    if impl == "fused":
        levels = f2_feature_pyramid(fmap2, num_levels)
        return lambda c: corr_lookup_fused(fmap1, levels, c, radius, block)
    if impl == "hybrid":
        rest = corr_pyramid_pooled(fmap1, fmap2, num_levels, start_level=1)
        return lambda c: corr_lookup_hybrid(fmap1, fmap2, rest, c, radius,
                                            block)
    pyramid = corr_pyramid_pooled(fmap1, fmap2, num_levels)
    return lambda c: corr_lookup_window(pyramid, c, radius)
