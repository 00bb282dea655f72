"""Universal-perturbation PCFA (`pcfa_tpu/attack/universal.py`): one δ for
a whole dataset.

A single (H′, W′, 3) perturbation (two in disjoint mode) is added to
every frame of every batch, broadcast over the batch, and optimized by the
L-BFGS of `attack/lbfgs.py` (torch `LBFGS` semantics, either direction, a
bf16 history allowed) whose state persists across all batches: the caller
passes it in and gets it back. The perturbed images are clipped to [0, 1]
inside the objective (`clip01`, whose derivative on a bound is ½ as
`jnp.clip`'s); there is no change-of-variables path, and the penalty acts
on the raw δ.

The optimizer works on one problem: its state has a pair axis of 1, and
`x` (1, n) holds δ1 then δ2 (δ once in joint mode). Loss and metrics are
taken over the whole batch, scalars per step, (steps,) per call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from pcfa_tpu_torch._device import resolve_device
from pcfa_tpu_torch.attack.boxconstraint import clip01
from pcfa_tpu_torch.attack.lbfgs import LBFGSState, lbfgs_init, lbfgs_iteration
from pcfa_tpu_torch.attack.losses import (
    avg_epe,
    loss_delta_constraint,
    two_norm_avg,
    two_norm_avg_delta,
)


@dataclasses.dataclass(frozen=True)
class UniversalConfig:
    steps: int = 20
    max_iter: int = 10
    delta_bound: float = 0.005
    mu: float = 100.0          # resolve with PCFAConfig.resolved_mu upstream
    loss: str = "aee"
    joint_perturbation: bool = False
    lr: float = 1.0
    history_size: int = 100
    lbfgs_direction: str = "two_loop"
    lbfgs_history_dtype: str | None = None


class UniversalMetrics(NamedTuple):
    loss: torch.Tensor
    aee_adv_tgt: torch.Tensor
    aee_adv_pred: torch.Tensor
    l2_delta1: torch.Tensor
    l2_delta2: torch.Tensor
    l2_delta12: torch.Tensor


def universal_init(delta_shape: tuple[int, ...], config: UniversalConfig,
                   device: str | torch.device = "cuda") -> LBFGSState:
    """Fresh L-BFGS state at δ = 0 for the single-image padded shape
    `delta_shape` (H′, W′, 3); the optimizer variable is float32, as the
    JAX package's."""
    n = math.prod(delta_shape) * (1 if config.joint_perturbation else 2)
    x0 = torch.zeros((1, n), device=resolve_device(device))
    return lbfgs_init(x0, config.history_size, config.lbfgs_history_dtype)


def unpack_deltas(x: torch.Tensor, delta_shape: tuple[int, ...],
                  joint: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The flat variable (n,) as (δ1, δ2), each `delta_shape`."""
    if joint:
        d1 = x.reshape(delta_shape)
        return d1, d1
    n = x.shape[0] // 2
    return x[:n].reshape(delta_shape), x[n:].reshape(delta_shape)


def universal_batch_attack(
        flow_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        images1: torch.Tensor, images2: torch.Tensor, target: torch.Tensor,
        opt_state: LBFGSState, config: UniversalConfig
) -> tuple[LBFGSState, UniversalMetrics, torch.Tensor, torch.Tensor]:
    """`steps` L-BFGS segments of `max_iter` iterations on one batch,
    padded unit-range (B, H′, W′, 3) on the state's device; δ broadcasts
    over B. Returns (opt_state′, per-step metrics, flow_pred_init,
    flow_pred)."""
    cfg = config
    target = target.to(opt_state.x.device)

    def value_and_grad(x, perturbed):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            px1, px2, d1, d2 = perturbed(x)
            loss = loss_delta_constraint(flow_fn(px1, px2), target, d1, d2,
                                         cfg.delta_bound, cfg.mu, cfg.loss)
            (grad,) = torch.autograd.grad(loss, x)
        return loss.detach().reshape(1).to(x.dtype), grad

    return run_batch(flow_fn, images1, images2, target, opt_state, cfg,
                     value_and_grad, avg_epe)


def run_batch(flow_fn, images1, images2, target, opt_state: LBFGSState,
              cfg: UniversalConfig, value_and_grad, mean_epe
              ) -> tuple[LBFGSState, UniversalMetrics, torch.Tensor,
                         torch.Tensor]:
    """The batch loop of `universal_batch_attack`, given the objective
    `value_and_grad(x, perturbed)` → ((1,) value, (1, n) gradient), where
    `perturbed(x)` gives (clipped frames 1 and 2, δ1, δ2), and the mean
    endpoint error `mean_epe(a, b)` the metrics take over the batch. The
    data-parallel engine (`parallel.dp`) passes its global ones."""
    delta_shape = tuple(images1.shape[1:])
    dev = opt_state.x.device
    images1, images2, target = (t.to(dev) for t in (images1, images2,
                                                     target))

    def perturbed(x):
        d1, d2 = unpack_deltas(x[0], delta_shape, cfg.joint_perturbation)
        return clip01(images1 + d1[None]), clip01(images2 + d2[None]), d1, d2

    with torch.no_grad():
        flow_pred_init = flow_fn(images1, images2)
    steps = []
    for _ in range(cfg.steps):
        for pos in range(cfg.max_iter):
            opt_state, seg_loss = lbfgs_iteration(
                lambda x: value_and_grad(x, perturbed), opt_state, pos,
                lr=cfg.lr, direction=cfg.lbfgs_direction)
        with torch.no_grad():
            px1, px2, d1, d2 = perturbed(opt_state.x)
            flow_pred = flow_fn(px1, px2)
            steps.append(UniversalMetrics(
                loss=seg_loss[0],
                aee_adv_tgt=mean_epe(flow_pred, target),
                aee_adv_pred=mean_epe(flow_pred, flow_pred_init),
                l2_delta1=two_norm_avg(d1),
                l2_delta2=two_norm_avg(d2),
                l2_delta12=two_norm_avg_delta(d1, d2),
            ))
    metrics = UniversalMetrics(*(torch.stack(v) for v in zip(*steps)))
    return opt_state, metrics, flow_pred_init, flow_pred
