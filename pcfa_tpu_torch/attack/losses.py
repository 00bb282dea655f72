"""Attack losses and perturbation norms (`pcfa_tpu/attack/losses.py`).

Flow fields are channels-last (..., H, W, 2). Each function reduces over
every element it is given; the PCFA engine applies them pair by pair.
The cosine-similarity loss is the corrected `1 - <p,t>/(‖p‖·‖t‖)`, not the
reference's operator-precedence bug.
"""

from __future__ import annotations

import torch


def avg_epe(flow1: torch.Tensor, flow2: torch.Tensor) -> torch.Tensor:
    """Average endpoint error: mean over pixels of ‖Δflow‖₂."""
    return torch.sqrt(torch.sum((flow1 - flow2) ** 2, dim=-1)).mean()


def avg_mse(flow1: torch.Tensor, flow2: torch.Tensor) -> torch.Tensor:
    return torch.mean((flow1 - flow2) ** 2)


def f_cosim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 − global cosine similarity (corrected form)."""
    dot = torch.sum(pred * target)
    denom = torch.sqrt(torch.sum(pred * pred)) * torch.sqrt(
        torch.sum(target * target))
    return 1.0 - dot / denom


def get_loss(f_type: str, pred: torch.Tensor,
             target: torch.Tensor) -> torch.Tensor:
    if f_type == "aee":
        return avg_epe(pred, target)
    if f_type == "mse":
        return avg_mse(pred, target)
    if f_type == "cosim":
        return f_cosim(pred, target)
    raise NotImplementedError(
        f"The requested loss type {f_type} does not exist. "
        "Please choose one of 'aee', 'mse' or 'cosim'")


def two_norm_avg(x: torch.Tensor) -> torch.Tensor:
    """‖x‖₂ / sqrt(numel)."""
    return torch.sqrt(torch.sum(x.to(torch.float32) ** 2)) / x.numel() ** 0.5


def two_norm_avg_delta(delta1: torch.Tensor,
                       delta2: torch.Tensor) -> torch.Tensor:
    """sqrt(‖δ1‖² + ‖δ2‖²) / sqrt(numel1 + numel2)."""
    numels = float(delta1.numel() + delta2.numel())
    return torch.sqrt(torch.sum(delta1 ** 2) + torch.sum(delta2 ** 2)) \
        / numels ** 0.5


def two_norm_avg_delta_squared(delta1: torch.Tensor,
                               delta2: torch.Tensor) -> torch.Tensor:
    numels = float(delta1.numel() + delta2.numel())
    return (torch.sum(delta1 ** 2) + torch.sum(delta2 ** 2)) / numels


def relu_penalty(delta1: torch.Tensor, delta2: torch.Tensor,
                 delta_bound: float = 0.001) -> torch.Tensor:
    """relu(‖δ‖²_avg − bound²) as a maximum with 0, whose derivative
    where ‖δ‖²_avg equals bound² is ½, as `jnp.maximum`'s
    (`torch.clamp` gives 1 there)."""
    excess = two_norm_avg_delta_squared(delta1, delta2) - delta_bound ** 2
    return torch.maximum(excess, torch.zeros_like(excess))


def loss_delta_constraint(pred: torch.Tensor, target: torch.Tensor,
                          delta1: torch.Tensor, delta2: torch.Tensor,
                          delta_bound: float = 0.001, mu: float = 100.0,
                          f_type: str = "aee") -> torch.Tensor:
    """similarity(pred, target) + mu·relu-penalty(δ)."""
    return get_loss(f_type, pred, target) + mu * relu_penalty(
        delta1, delta2, delta_bound)


def default_mu(delta_bound: float, target: str) -> float:
    """2500/bound, ×1.5 for non-zero targets."""
    mu = 2500.0 / delta_bound
    if target not in ("zero",):
        mu = 1.5 * mu
    return mu
