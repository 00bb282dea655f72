"""PCFA traffic: `pcfa_init`, then the attack's outer steps, each one call
of `pcfa_outer_step`, exactly the loop `pcfa_attack` runs (and the
`attack_pcfa` CLI through it)."""

from __future__ import annotations

import dataclasses

import torch

from pcfa_tpu_torch import config as program_config
from pcfa_tpu_torch.attack import pcfa

SPAN = "bench.outer_step"
#: the traced slice: global steps 1 and 2 (the second and third outer
#: steps of the first attack)
SLICE = (1, 2)


def attack_config(net: str, t: dict) -> pcfa.PCFAConfig:
    """The config the CLI builds, with the environment the cell sets."""
    return pcfa.PCFAConfig(
        steps=t["steps"], max_iter=t["max_iter"],
        delta_bound=t["delta_bound"], mu=t["mu"], loss=t["loss"],
        target=t["target"], boxconstraint=t["boxconstraint"],
        joint_perturbation=t["joint"], eps_box=t["eps_box"],
        history_size=t["history_size"],
        lbfgs_direction=program_config.lbfgs_direction(),
        lbfgs_history_dtype=program_config.lbfgs_history_dtype(net))


class Attack:
    """One attack on a batch of padded pairs."""

    def __init__(self, flow_fn, cfg, image1, image2, target, device):
        self.flow_fn, self.cfg = flow_fn, cfg
        self.image1, self.image2, self.target = image1, image2, target
        self.state, self.flow_init = pcfa.pcfa_init(flow_fn, image1, image2,
                                                    cfg, device)

    def step(self):
        """One outer step → per-pair (aee_adv_tgt, l2_delta12, the flow at
        the new iterate)."""
        self.state, m, flow = pcfa.pcfa_outer_step(
            self.flow_fn, self.image1, self.image2, self.target,
            self.flow_init, self.state, self.cfg)
        return m.aee_adv_tgt, m.l2_delta12, flow

    def stage(self, b: int) -> dict:
        """Pair `b`'s L-BFGS state, on the host: the iterate, the last
        direction and step length, the gradient the direction was computed
        from, the curvature pairs of the history as stored (oldest first),
        γ, the iterations run, and whether the iterate took the last step
        (the state keeps that step's length finite only then)."""
        o = self.state.opt
        m = o.s_buf.shape[1]
        count = int(o.count[b])
        valid = min(count, m)
        ring = [(count - valid + i) % m for i in range(valid)]
        return {"state": {
            "x": o.x[b].cpu(), "d": o.d[b].cpu(), "t": float(o.t[b]),
            "grad": o.prev_grad[b].cpu(),
            "steps": [o.s_buf[b, i].cpu() for i in ring],
            "diffs": [o.y_buf[b, i].cpu() for i in ring],
            "h_diag": float(o.h_diag[b]), "iterations": int(o.n_iter[b]),
            "applied": bool(torch.isfinite(o.last_step_max[b]))}}


class Runner:
    span, slice = SPAN, SLICE

    def __init__(self, flow_fn, net: str, traffic: dict, device):
        self.flow_fn, self.device = flow_fn, device
        self.cfg = attack_config(net, traffic)
        self.steps = self.cfg.steps
        self.closures_per_step = self.cfg.max_iter

    def start(self, image1, image2, target) -> Attack:
        return Attack(self.flow_fn, self.cfg, image1, image2, target,
                      self.device)

    def warm_up(self, image1, image2, target) -> None:
        """One outer step of two iterations: the first iteration's path
        and the history's, at the cell's shapes."""
        cfg = dataclasses.replace(self.cfg, max_iter=2)
        att = Attack(self.flow_fn, cfg, image1, image2, target, self.device)
        att.step()
        att.stage(0)
        del att
        if self.device.type == "cuda":
            torch.cuda.synchronize()
