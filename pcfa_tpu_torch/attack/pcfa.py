"""PCFA attack engine (`pcfa_tpu/attack/pcfa.py`) for B independent image
pairs at once.

The JAX bench `vmap`s B single-pair attacks; here the leading axis of
`image1`/`image2` (B, H, W, 3) is the pair axis. The network runs once on
the (B, …) batch; the loss is computed pair by pair and the gradient is
taken of their sum, which gives every pair exactly its own gradient (the
networks are per-sample: instance norm, frozen batch norm, per-pair
correlation). The L-BFGS state, the best-δ latch and all metrics carry the
pair axis; metrics are (B,) per outer step and (B, steps) from
`pcfa_attack`.

Semantics kept: torch L-BFGS (max_iter per outer step, lr 1, no line
search) with state persisting across outer steps; disjoint mode optimizes
the two network inputs (clipping) or their tanh preimages
(change_of_variables); joint mode optimizes one δ added to both frames;
joint + change_of_variables is rejected; best-δ-under-bound tracking with
the reference's update rule and float tie-break.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from pcfa_tpu_torch._device import resolve_device
from pcfa_tpu_torch.attack import boxconstraint as bc
from pcfa_tpu_torch.attack.lbfgs import LBFGSState, lbfgs_init, lbfgs_iteration
from pcfa_tpu_torch.attack.losses import (
    avg_epe,
    default_mu,
    loss_delta_constraint,
    two_norm_avg,
    two_norm_avg_delta,
)


@dataclasses.dataclass(frozen=True)
class PCFAConfig:
    """Attack hyper-parameters (defaults as `pcfa_tpu`)."""

    steps: int = 20
    max_iter: int = 10
    delta_bound: float = 0.005
    mu: float | None = None       # None → 2500/bound heuristic
    loss: str = "aee"
    target: str = "zero"          # used only for the mu heuristic
    boxconstraint: str = "clipping"
    joint_perturbation: bool = False
    eps_box: float = 1e-7
    lr: float = 1.0
    history_size: int = 100
    lbfgs_direction: str = "two_loop"
    lbfgs_history_dtype: str | None = None

    def resolved_mu(self) -> float:
        if self.mu is not None and self.mu >= 0:
            return self.mu
        return default_mu(self.delta_bound, self.target)

    def __post_init__(self):
        if self.joint_perturbation and \
                self.boxconstraint == "change_of_variables":
            raise ValueError(
                "Training a --joint_perturbation with "
                "--boxconstraint=change_of_variables is not defined. "
                "Please use --boxconstraint=clipping.")


class PCFAMetrics(NamedTuple):
    loss: torch.Tensor
    aee_adv_tgt: torch.Tensor       # aee_predadv-tgt
    aee_adv_pred: torch.Tensor      # aee_pred-predadv
    l2_delta1: torch.Tensor
    l2_delta2: torch.Tensor
    l2_delta12: torch.Tensor        # l2_delta-avg
    aee_adv_tgt_min: torch.Tensor
    aee_adv_pred_min: torch.Tensor
    l2_delta12_min: torch.Tensor


class PCFABest(NamedTuple):
    below: torch.Tensor
    l2_min: torch.Tensor
    aee_tgt_min: torch.Tensor
    aee_pred_min: torch.Tensor
    delta1: torch.Tensor
    delta2: torch.Tensor
    flow: torch.Tensor


class PCFAState(NamedTuple):
    opt: LBFGSState
    best: PCFABest


class PCFAResult(NamedTuple):
    delta1: torch.Tensor
    delta2: torch.Tensor
    delta1_best: torch.Tensor
    delta2_best: torch.Tensor
    flow_pred_init: torch.Tensor
    flow_pred: torch.Tensor
    flow_pred_best: torch.Tensor
    metrics: PCFAMetrics


def _per_pair(fn, *tensors) -> torch.Tensor:
    """(B,) values of `fn` applied to each pair's slice of `tensors`."""
    return torch.stack([fn(*(t[b] for t in tensors))
                        for b in range(tensors[0].shape[0])])


def _make_problem(flow_fn, image1, image2, target, cfg: PCFAConfig):
    """Closures mapping the (B, n) optimizer variable to inputs, δs, and
    per-pair loss and gradient."""
    mu = cfg.resolved_mu()
    B = image1.shape[0]
    n_img = image1[0].numel()

    if cfg.joint_perturbation:
        images_max = torch.maximum(image1, image2)
        images_min = torch.minimum(image1, image2)

        def network_inputs(x):
            d = x.reshape(image1.shape)
            return bc.clip01(image1 + d), bc.clip01(image2 + d)

        def deltas(x):
            return bc.extract_deltas_joint(x.reshape(image1.shape),
                                           images_max, images_min)

        x0 = torch.zeros((B, n_img), dtype=image1.dtype, device=image1.device)
    else:
        def unpack(x):
            return (x[:, :n_img].reshape(image1.shape),
                    x[:, n_img:].reshape(image1.shape))

        def network_inputs(x):
            return bc.perturbed_images(*unpack(x), cfg.boxconstraint,
                                       cfg.eps_box)

        def deltas(x):
            return bc.extract_deltas(*unpack(x), image1, image2,
                                     cfg.boxconstraint, cfg.eps_box)

        i1, i2 = bc.init_nw_inputs(image1, image2, cfg.boxconstraint,
                                   cfg.eps_box)
        x0 = torch.cat([i1.reshape(B, -1), i2.reshape(B, -1)], dim=1)

    def pair_loss(flow, tgt, d1, d2):
        return loss_delta_constraint(flow, tgt, d1, d2, cfg.delta_bound, mu,
                                     cfg.loss)

    def value_and_grad(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            flow = flow_fn(*network_inputs(x))
            loss = _per_pair(pair_loss, flow, target, *deltas(x))
            (grad,) = torch.autograd.grad(loss.sum(), x)
        return loss.detach(), grad

    return x0, network_inputs, deltas, value_and_grad


def pcfa_init(flow_fn, image1, image2, config: PCFAConfig,
              device: str | torch.device = "cuda"
              ) -> tuple[PCFAState, torch.Tensor]:
    """(initial state, flow_pred_init) for B pairs (B, H, W, 3)."""
    dev = resolve_device(device)
    image1, image2 = image1.to(dev), image2.to(dev)
    cfg = config
    x0, _, _, _ = _make_problem(flow_fn, image1, image2, None, cfg)
    with torch.no_grad():
        flow_pred_init = flow_fn(image1, image2)
    B = image1.shape[0]
    kw = {"dtype": image1.dtype, "device": dev}
    best0 = PCFABest(
        below=torch.zeros(B, dtype=torch.bool, device=dev),
        l2_min=torch.full((B,), float("inf"), **kw),
        aee_tgt_min=torch.full((B,), float("inf"), **kw),
        aee_pred_min=torch.zeros(B, **kw),
        delta1=torch.zeros_like(image1),
        delta2=torch.zeros_like(image1),
        flow=flow_pred_init,
    )
    opt = lbfgs_init(x0, cfg.history_size, cfg.lbfgs_history_dtype)
    return PCFAState(opt=opt, best=best0), flow_pred_init


def pcfa_outer_step(flow_fn, image1, image2, target, flow_pred_init,
                    state: PCFAState, config: PCFAConfig
                    ) -> tuple[PCFAState, PCFAMetrics, torch.Tensor]:
    """One outer step: a `max_iter` L-BFGS segment, flow re-prediction,
    metrics and the best-δ update, per pair."""
    cfg = config
    _, network_inputs, deltas, value_and_grad = _make_problem(
        flow_fn, image1, image2, target, cfg)
    opt, best = state
    for pos in range(cfg.max_iter):
        opt, seg_loss = lbfgs_iteration(value_and_grad, opt, pos, lr=cfg.lr,
                                        direction=cfg.lbfgs_direction)

    with torch.no_grad():
        flow_pred = flow_fn(*network_inputs(opt.x))
        d1, d2 = deltas(opt.x)
        aee_adv_tgt = _per_pair(avg_epe, flow_pred, target)
        aee_adv_pred = _per_pair(avg_epe, flow_pred, flow_pred_init)
        l2_d12 = _per_pair(two_norm_avg_delta, d1, d2)

        in_bound = l2_d12 <= cfg.delta_bound
        upd_not_below = (l2_d12 < best.l2_min) | (
            (l2_d12 == best.l2_min) & (aee_adv_tgt < best.aee_tgt_min))
        upd_below = in_bound & (aee_adv_tgt < best.aee_tgt_min)
        update = torch.where(best.below, upd_below, upd_not_below)
        below = best.below | (update & in_bound)

        def pick(new, old):
            return torch.where(update.reshape(-1, *([1] * (new.dim() - 1))),
                               new, old)

        best = PCFABest(
            below=below,
            l2_min=pick(l2_d12, best.l2_min),
            aee_tgt_min=pick(aee_adv_tgt, best.aee_tgt_min),
            aee_pred_min=pick(aee_adv_pred, best.aee_pred_min),
            delta1=pick(d1, best.delta1),
            delta2=pick(d2, best.delta2),
            flow=pick(flow_pred, best.flow),
        )
        metrics = PCFAMetrics(
            loss=seg_loss,
            aee_adv_tgt=aee_adv_tgt,
            aee_adv_pred=aee_adv_pred,
            l2_delta1=_per_pair(two_norm_avg, d1),
            l2_delta2=_per_pair(two_norm_avg, d2),
            l2_delta12=l2_d12,
            aee_adv_tgt_min=best.aee_tgt_min,
            aee_adv_pred_min=best.aee_pred_min,
            l2_delta12_min=best.l2_min,
        )
    return PCFAState(opt=opt, best=best), metrics, flow_pred


def pcfa_attack(flow_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                image1: torch.Tensor, image2: torch.Tensor,
                target: torch.Tensor, config: PCFAConfig,
                device: str | torch.device = "cuda") -> PCFAResult:
    """Full PCFA optimization for B pairs. Images: unit-range, padded to
    the network divisor, (B, H, W, 3); `flow_fn(x1, x2)` returns the
    (unpadded) flow entering the loss; `target` matches its shape."""
    dev = resolve_device(device)
    image1, image2, target = image1.to(dev), image2.to(dev), target.to(dev)
    cfg = config
    state, flow_pred_init = pcfa_init(flow_fn, image1, image2, cfg, dev)
    _, _, deltas, _ = _make_problem(flow_fn, image1, image2, target, cfg)
    steps = []
    for _ in range(cfg.steps):
        state, metrics, flow_pred = pcfa_outer_step(
            flow_fn, image1, image2, target, flow_pred_init, state, cfg)
        steps.append(metrics)
    with torch.no_grad():
        d1_final, d2_final = deltas(state.opt.x)
    return PCFAResult(
        delta1=d1_final,
        delta2=d2_final,
        delta1_best=state.best.delta1,
        delta2_best=state.best.delta2,
        flow_pred_init=flow_pred_init,
        flow_pred=flow_pred,
        flow_pred_best=state.best.flow,
        metrics=PCFAMetrics(*(torch.stack(v, dim=1) for v in zip(*steps))),
    )
