"""I-FGSM attack (`pcfa_tpu/attack/fgsm.py`) for B independent image pairs
at once.

Iterated fast-gradient-sign steps on the two network inputs, targeted
(gradient descent toward the target): x ← clip(x − ε·sign(∇x loss), 0, 1).
Joint mode averages the two images' gradients before the sign. One step is
one forward and backward for the gradient plus one forward for the metrics.
`torch.sign(0)` is 0, as `jnp.sign`'s.

As in `attack/pcfa.py`, the leading axis of the images is the pair axis:
the loss is taken pair by pair and the gradient of their sum gives every
pair its own, as the JAX bench vmaps single-pair attacks. Metrics are (B,)
per step and (B, steps) from `fgsm_attack`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from pcfa_tpu_torch._device import resolve_device
from pcfa_tpu_torch.attack.boxconstraint import clip01
from pcfa_tpu_torch.attack.losses import (
    avg_epe,
    get_loss,
    two_norm_avg,
    two_norm_avg_delta,
)
from pcfa_tpu_torch.attack.pcfa import _per_pair
from pcfa_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class FGSMConfig:
    steps: int = 20
    epsilon: float = 0.00025
    loss: str = "aee"
    joint_perturbation: bool = False


class FGSMMetrics(NamedTuple):
    loss: torch.Tensor
    aee_adv_tgt: torch.Tensor
    aee_adv_pred: torch.Tensor
    l2_delta1: torch.Tensor
    l2_delta2: torch.Tensor
    l2_delta12: torch.Tensor


class FGSMResult(NamedTuple):
    delta1: torch.Tensor
    delta2: torch.Tensor
    flow_pred_init: torch.Tensor
    flow_pred: torch.Tensor
    metrics: FGSMMetrics


def fgsm_step(flow_fn, image1, image2, target, flow_pred_init,
              carry: tuple[torch.Tensor, torch.Tensor], config: FGSMConfig
              ) -> tuple[tuple[torch.Tensor, torch.Tensor],
                         tuple[FGSMMetrics, torch.Tensor]]:
    """One I-FGSM step: `carry = (nw1, nw2)`, the current network inputs
    (B, H, W, 3) → (new carry, (metrics, flow_pred))."""
    with profiling.span("fgsm.step"):
        return _fgsm_step(flow_fn, image1, image2, target, flow_pred_init,
                          carry, config)


def _fgsm_step(flow_fn, image1, image2, target, flow_pred_init, carry, cfg):
    nw1, nw2 = carry
    with profiling.span("fgsm.objective"), torch.enable_grad():
        a = nw1.detach().requires_grad_(True)
        b = nw2.detach().requires_grad_(True)
        loss = _per_pair(lambda f, t: get_loss(cfg.loss, f, t),
                         flow_fn(a, b), target)
        g1, g2 = torch.autograd.grad(loss.sum(), (a, b))
    with profiling.span("fgsm.update"):
        if cfg.joint_perturbation:
            s1 = s2 = torch.sign(0.5 * (g1 + g2))
        else:
            s1, s2 = torch.sign(g1), torch.sign(g2)
        nw1 = clip01(nw1 - cfg.epsilon * s1)
        nw2 = clip01(nw2 - cfg.epsilon * s2)

        with torch.no_grad():
            d1, d2 = nw1 - image1, nw2 - image2
            flow_pred = flow_fn(nw1, nw2)
            metrics = FGSMMetrics(
                loss=loss.detach(),
                aee_adv_tgt=_per_pair(avg_epe, flow_pred, target),
                aee_adv_pred=_per_pair(avg_epe, flow_pred, flow_pred_init),
                l2_delta1=_per_pair(two_norm_avg, d1),
                l2_delta2=_per_pair(two_norm_avg, d2),
                l2_delta12=_per_pair(two_norm_avg_delta, d1, d2),
            )
    return (nw1, nw2), (metrics, flow_pred)


def fgsm_attack(flow_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                image1: torch.Tensor, image2: torch.Tensor,
                target: torch.Tensor, config: FGSMConfig,
                device: str | torch.device = "cuda") -> FGSMResult:
    """I-FGSM on B pairs: unit-range images padded to the network divisor,
    (B, H, W, 3); `flow_fn(x1, x2)` returns the (unpadded) flow entering
    the loss; `target` matches its shape."""
    dev = resolve_device(device)
    image1, image2, target = image1.to(dev), image2.to(dev), target.to(dev)
    with torch.no_grad():
        flow_pred_init = flow_fn(image1, image2)
    carry, steps = (image1, image2), []
    for _ in range(config.steps):
        carry, (metrics, flow_pred) = fgsm_step(
            flow_fn, image1, image2, target, flow_pred_init, carry, config)
        steps.append(metrics)
    return FGSMResult(
        delta1=carry[0] - image1,
        delta2=carry[1] - image2,
        flow_pred_init=flow_pred_init,
        flow_pred=flow_pred,
        metrics=FGSMMetrics(*(torch.stack(v, dim=1) for v in zip(*steps))),
    )
