"""Per-pixel channel L2 norm (`pcfa_tpu/ops/channelnorm.py`), FlowNet2's
`channelnorm` in place of the reference's CUDA extension."""

from __future__ import annotations

import torch


def channel_norm(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """(B, H, W, C) → (B, H, W, 1): sqrt(Σ_c x² + eps). With eps 0 the
    gradient at an exact zero is NaN, as in the JAX package."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)
