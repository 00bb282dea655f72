"""I-FGSM traffic: the forward for `flow_pred_init`, then the attack's
steps, each one call of `fgsm_step`, as `fgsm_attack` loops them."""

from __future__ import annotations

import torch

from pcfa_tpu_torch.attack import fgsm

SPAN = "bench.fgsm_step"


class Attack:
    def __init__(self, flow_fn, cfg, image1, image2, target):
        self.flow_fn, self.cfg = flow_fn, cfg
        self.image1, self.image2, self.target = image1, image2, target
        with torch.no_grad():
            self.flow_init = flow_fn(image1, image2)
        self.carry = (image1, image2)

    def step(self):
        """One step → per-pair (aee_adv_tgt, l2_delta12, the flow at the
        new inputs)."""
        self.carry, (m, flow) = fgsm.fgsm_step(
            self.flow_fn, self.image1, self.image2, self.target,
            self.flow_init, self.carry, self.cfg)
        return m.aee_adv_tgt, m.l2_delta12, flow

    def stage(self, b: int) -> dict:
        """Pair `b`'s δ after the steps so far, flat, on the host."""
        return {"delta": torch.cat([(self.carry[0][b] - self.image1[b])
                                    .flatten(),
                                    (self.carry[1][b] - self.image2[b])
                                    .flatten()]).cpu()}


class Runner:
    span = SPAN

    def __init__(self, flow_fn, net: str, traffic: dict, device):
        self.flow_fn, self.device = flow_fn, device
        self.cfg = fgsm.FGSMConfig(steps=traffic["steps"],
                                   epsilon=traffic["epsilon"],
                                   loss=traffic["loss"],
                                   joint_perturbation=traffic["joint"])
        self.steps = self.cfg.steps
        self.closures_per_step = 1
        # the traced slice: the whole second attack, its first forward
        # included
        self.slice = (self.steps, self.steps)

    def start(self, image1, image2, target) -> Attack:
        return Attack(self.flow_fn, self.cfg, image1, image2, target)

    def warm_up(self, image1, image2, target) -> None:
        att = self.start(image1, image2, target)
        att.step()
        att.stage(0)
        del att
        if self.device.type == "cuda":
            torch.cuda.synchronize()
