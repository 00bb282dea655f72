"""The plain reference against `pcfa_tpu_torch` on the CPU, on the same
weight file in the published layout: the forward in float32, and the
first closure's gradient, one PCFA outer step (rerun by the reference's
copy of torch's L-BFGS, and its last direction worked out again from the
program's own state) and one I-FGSM step in float64. (In float32 the
input gradient of a random RAFT at 128 pixels moves by up to 1% with
rounding alone, as ReLUs switch; float64 pins the semantics.)"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import cells
import check
import synthetic
import weights
from reference import attack, common

from conftest import tiny_cell


def _pair(name, dtype, tmp_path):
    cell = tiny_cell(name)
    cfg = cell.config
    ref_module = cells.module("reference", cfg["reference"])
    with torch.device("meta"):
        published = getattr(ref_module, cfg["reference_class"])(
            **cfg["model"])
    path = os.path.join(tmp_path, "w.pth")
    weights.save(weights.make(published, 5, torch.device("cpu"),
                              **cfg["weights"]), path,
                 cfg["checkpoint_container"])
    from pcfa_tpu_torch import runtime

    loaded = runtime.load_model(cfg["net"], checkpoint=path, device="cpu",
                                **cfg["model"])
    loaded.module.to(dtype)
    padder, flow_fn = runtime.make_flow_fn(loaded, tuple(cfg["image_hw"]),
                                           cfg["pad_mode"])
    net = check.reference_net(cfg, ref_module, path, "cpu").to(dtype)
    pad = common.pad_amounts(cfg["image_hw"], cfg["pad_divisor"],
                             cfg["pad_mode"])
    a, b = synthetic.batch(9, 0, 1, tuple(cfg["image_hw"]))
    x1, x2 = (torch.from_numpy(x).to(dtype) for x in (a, b))
    p1, p2 = padder.pad(x1, x2)
    assert torch.equal(p1, common.pad(x1, pad))
    return cell, flow_fn, (lambda u, v: common.unpad(net(u, v), pad)), p1, p2


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("name", ["raft-pcfa-kitti-b2",
                                  "pwcnet-pcfa-kitti-b1"])
def test_forward_matches_in_float32(name, tmp_path):
    _, prog, ref, p1, p2 = _pair(name, torch.float32, tmp_path)
    with torch.no_grad():
        got, want = prog(p1, p2), ref(p1, p2)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-4
    assert float(want.abs().mean()) > 1e-3


@pytest.mark.parametrize("name", ["raft-pcfa-kitti-b2",
                                  "pwcnet-pcfa-kitti-b1"])
def test_closure_and_outer_step_match_in_float64(name, tmp_path):
    from pcfa_tpu_torch.attack import pcfa

    cell, prog, ref, p1, p2 = _pair(name, torch.float64, tmp_path)
    t = cell.traffic
    target = torch.zeros(p1.shape[0], *cell.config["image_hw"], 2,
                         dtype=torch.float64)
    loss, grad = attack.first_closure(ref, p1, p2, target)
    a = p1.clone().requires_grad_(True)
    b = p2.clone().requires_grad_(True)
    got_loss = attack.avg_epe(prog(a, b), target)
    got = torch.autograd.grad(got_loss, (a, b))
    # the program's flow function hands the flow back in float32
    assert abs(float(got_loss.detach()) - loss) < 1e-6 * loss
    assert _rel(torch.cat([g.flatten() for g in got]), grad) < 1e-6

    cfg = pcfa.PCFAConfig(steps=1, max_iter=t["max_iter"],
                          delta_bound=t["delta_bound"], loss="aee",
                          boxconstraint=t["boxconstraint"],
                          eps_box=t["eps_box"],
                          history_size=t["history_size"],
                          lbfgs_direction="two_loop")
    state, flow0 = pcfa.pcfa_init(prog, p1, p2, cfg, "cpu")
    state, m, _ = pcfa.pcfa_outer_step(prog, p1, p2, target, flow0, state,
                                       cfg)
    want = attack.pcfa_step(ref, p1, p2, target, t)
    o = state.opt
    assert _rel(o.x[0], want["x"]) < 1e-5
    assert _rel(o.d[0], want["d"]) < 1e-5
    assert int(o.count[0]) == len(want["steps"]) > 0
    # the last direction, worked out again from the program's own state
    steps = [o.s_buf[0, i] for i in range(int(o.count[0]))]
    diffs = [o.y_buf[0, i] for i in range(int(o.count[0]))]
    h = float(diffs[-1] @ steps[-1] / (diffs[-1] @ diffs[-1]))
    assert _rel(o.d[0], attack.two_loop(o.prev_grad[0], steps, diffs, h)) \
        < 1e-9
    # the compact form the cells state gives the same direction
    assert _rel(attack.compact(o.prev_grad[0], steps, diffs, h),
                attack.two_loop(o.prev_grad[0], steps, diffs, h)) < 1e-9
    x1, x2, d1, d2 = want["inputs"]
    with torch.no_grad():
        aee = float(attack.avg_epe(ref(x1, x2), target))
    assert abs(float(m.aee_adv_tgt[0]) - aee) < 1e-5 * aee
    l2 = float(attack.two_norm_avg_delta(d1, d2))
    assert abs(float(m.l2_delta12[0]) - l2) < 1e-5 * l2
    assert l2 > 0


def test_fgsm_step_matches_in_float64(tmp_path):
    from pcfa_tpu_torch.attack import fgsm

    cell, prog, ref, p1, p2 = _pair("raft-ifgsm-kitti-b2", torch.float64,
                                    tmp_path)
    t = cell.traffic
    target = torch.zeros(1, *cell.config["image_hw"], 2, dtype=torch.float64)
    cfg = fgsm.FGSMConfig(steps=1, epsilon=t["epsilon"])
    with torch.no_grad():
        flow0 = prog(p1, p2)
    (n1, n2), (m, _) = fgsm.fgsm_step(prog, p1, p2, target, flow0, (p1, p2),
                                      cfg)
    _, grad = attack.first_closure(ref, p1, p2, target)
    r1, r2 = attack.fgsm_update(p1, p2, grad, t["epsilon"])
    assert torch.equal(n1, r1) and torch.equal(n2, r2)
    with torch.no_grad():
        aee = float(attack.avg_epe(ref(r1, r2), target))
    assert abs(float(m.aee_adv_tgt[0]) - aee) < 1e-6 * aee


def test_published_layout_is_the_reference_state_dict():
    """RAFT's file carries the BatchNorm statistics of cnet, and PWCNet's
    the unused deconv2, as the published files do."""
    from reference import pwcnet, raft

    keys = raft.RAFT().state_dict().keys()
    assert "cnet.norm1.running_var" in keys
    assert "cnet.layer2.0.downsample.1.num_batches_tracked" in keys
    assert "fnet.norm1.weight" not in keys
    assert "deconv2.weight" in pwcnet.PWCDCNet().state_dict()
    state = weights.make(raft.RAFT(iters=1), 3, torch.device("cpu"))
    assert torch.all(state["cnet.norm1.running_var"] >= 0.5)
    assert int(state["cnet.norm1.num_batches_tracked"]) == 1000
    np.testing.assert_allclose(
        float(state["fnet.conv1.weight"].std()), 1 / np.sqrt(3 * 49),
        rtol=0.1)
