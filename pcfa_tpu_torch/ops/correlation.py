"""Correlation ops of `pcfa_tpu/ops/correlation.py`: RAFT's pyramid and
window lookup (the materialized path). The plain patch correlation of
PWCNet (`local_correlation`) and FlowNetC (`global_correlation`) is
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

import torch

from pcfa_tpu_torch.config import corr_hbm_budget_bytes
from pcfa_tpu_torch.ops.corr_lookup import corr_window, corr_window_plain
from pcfa_tpu_torch.ops.warp import avg_pool2d


def resolve_corr_impl(impl: str, fmap1_shape: tuple, fmap2_shape: tuple,
                      num_levels: int, dtype: torch.dtype) -> str:
    """Resolve `corr_impl='auto'` as `pcfa_tpu` does: materialize the
    pyramid while its forward plus cotangent footprint fits
    PCFA_CORR_HBM_BUDGET_MB (default 6 GiB), else the blockwise fused
    lookup. Only 'materialized' is ported so far."""
    if impl == "auto":
        B, H1, W1, _ = fmap1_shape
        _, H2, W2, _ = fmap2_shape
        pyr_elems, h, w = 0, H2, W2
        for _ in range(num_levels):
            pyr_elems += h * w
            h, w = max(h // 2, 1), max(w // 2, 1)
        itemsize = torch.empty((), dtype=dtype).element_size()
        est = 2 * B * H1 * W1 * pyr_elems * itemsize
        impl = "materialized" if est <= corr_hbm_budget_bytes() else "fused"
    if impl != "materialized":
        raise NotImplementedError(
            f"corr_impl={impl!r}: only the materialized pyramid is ported; "
            "the fused and hybrid corr paths are a later slice of the port "
            "(ROADMAP.md)")
    return impl


def corr_pyramid_pooled(fmap1: torch.Tensor, fmap2: torch.Tensor,
                        num_levels: int = 4) -> list[torch.Tensor]:
    """Per-level correlation against avg-pooled f2 features:
    level l = f1 · avgpool²ˡ(f2)ᵀ / √C, each (B·H1·W1, H2ₗ, W2ₗ).
    The per-level product stays a `torch.matmul`."""
    B, H1, W1, C = fmap1.shape
    f1 = fmap1.reshape(B, H1 * W1, C)
    inv_sqrt_c = 1.0 / math.sqrt(C)
    pyramid = []
    f2_l = fmap2
    for level in range(num_levels):
        if level:
            f2_l = avg_pool2d(f2_l, 2, 2)
        _, H2, W2, _ = f2_l.shape
        cmap = torch.matmul(f1, f2_l.reshape(B, H2 * W2, C).transpose(1, 2))
        pyramid.append((cmap * inv_sqrt_c).reshape(B * H1 * W1, H2, W2))
    return pyramid


def corr_lookup(pyramid: list[torch.Tensor], coords: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """Plain radius-r window lookup (`bilinear_sampler` per level)."""
    B, H1, W1, _ = coords.shape
    out = corr_window_plain(pyramid, coords.reshape(B * H1 * W1, 2), radius)
    return out.reshape(B, H1, W1, -1)


def corr_lookup_window(pyramid: list[torch.Tensor], coords: torch.Tensor,
                       radius: int = 4) -> torch.Tensor:
    """The lookup RAFT runs: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. coords are detached (zero gradient)."""
    B, H1, W1, _ = coords.shape
    out = corr_window(pyramid, coords.reshape(B * H1 * W1, 2), radius)
    return out.reshape(B, H1, W1, -1)

