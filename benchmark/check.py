"""The comparison that decides `correct`.

The window's first attack is the one judged: what the timed path produced
for it, on a sample of its pairs drawn from the seed, against the plain
reference (`reference/`) run afterwards on the same images and the same
weight file. The reference checks the start from the images, and follows
the first step from the program's own state. A gap is a relative L2 gap
(`_rel`); where the configuration runs the program below float32 (its
`env`, the settings the program reads: `precision`), a gap is divided by
the reference's own gap at that precision on the same inputs (the
reference under `torch.autocast` to bf16 for the network; rounded to the
history's dtype for a stored step): 1 is what that precision costs on
this seed, and faults and lower precisions read many times it.

* `flow`: the flow of the attack's first forward;
* `grad`: the first closure's gradient with respect to the two network
  inputs, as the cosine distance 1 − cos (a relative L2 gap saturates near
  1 where the gradient's rounding is large: bf16 already moves a random
  RAFT's input gradient by a third);
* PCFA, the optimizer's update, from its state after the first outer step
  (infinite where that state holds no curvature pair, unless the segment
  stopped after its first iteration: a bf16 network can return the same
  loss for a first step below its input rounding, and the stopping rule
  then ends the segment, as torch's L-BFGS does; nothing is pushed):
  - `first_step`: the history's oldest step, the first iteration's (where
    the segment stopped after it, the step the state holds), against
    −min(1, 1/‖g₀‖₁)·g₀, with g₀ the first closure's input gradient carried
    to the optimizer's variable by the reference's change of variables: the
    step's length, its direction and the ring's first slot;
  - `iterate`: the iterate against the reference's start with the stored
    steps and, where the iterate took it, the last one added to it in
    float32, as the program adds them, over the length of that path (steps
    that partly cancel would blow a gap over the move itself up), where
    every iteration after the first pushed a pair (compared only then; 0
    where no judged pair shows that);
  - `curvature`: the newest stored pair's s·y/y·y against the γ the state
    holds (a stored y or s that is not the pair γ was taken from);
  - `step`: the last direction worked out again in float64 from the
    gradient, curvature pairs and γ the state holds, over the same at the
    history's precision (`curvature` and `step` have nothing to judge in a
    pair whose segment stopped after its first iteration);
  - `stop`, only where a pair's segment stopped after its first
    iteration: the stopping rule's own test, |L(x₁) − L(x₀)|, with L the
    reference's loss, in float64, of the flows of the segment's first two
    closures, at x₀ and at x₁: a loss flat in float32 reads under about
    one float32 rounding of it, a segment cut short without cause what the
    step moved the loss by;
* I-FGSM, `step`: the inputs after the first step, from the first
  closure's own gradient: the share of entries that differ (exact, limit
  0);
* `flow_step`: the flow at the program's iterate after the first step;
* `aee`, `l2`: the engine's `aee_adv_tgt` and `l2_delta12` after the
  first step against the reference's arithmetic on the program's own flow
  and δ there, relative gaps;
* `loss`: the first closure's loss, relative gap; shown, not judged (a
  mean of |flow| cancels its rounding, so it swings from seed to seed; the
  flow it is taken from is judged).

Why the step is followed and not rerun: from the same start, a float32
L-BFGS and the program's bf16 one part within one outer step (a bf16
network cannot see a δ below its input rounding, so its loss moves by
rounding where a float32 loss is flat), and no limit between sound runs
and a lower precision holds on δ itself.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import attack, common

NUMBERS = ("flow", "grad", "first_step", "iterate", "curvature", "step",
           "stop", "flow_step", "aee", "l2", "loss")


def precision(config: dict) -> dict[str, str]:
    """What the program runs in, from the configuration's `env`, with the
    program's own defaults: the network's dtype (`PCFA_COMPUTE_DTYPE`),
    the L-BFGS history's (`PCFA_LBFGS_DTYPE`) and the direction's form
    (`PCFA_LBFGS_DIRECTION`)."""
    env = config["env"]
    return {"network": env.get("PCFA_COMPUTE_DTYPE") or "float32",
            "history": env.get("PCFA_LBFGS_DTYPE") or "float32",
            "direction": env.get("PCFA_LBFGS_DIRECTION") or "compact"}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    norm = float(torch.linalg.vector_norm(b))
    gap = float(torch.linalg.vector_norm(a - b))
    return gap / norm if norm > 0 else (0.0 if gap == 0 else math.inf)


def _cos_distance(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    norms = float(torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b))
    return 1.0 - float(torch.dot(a, b)) / norms if norms > 0 else 1.0


def _scaled(gap: float, scale: float | None) -> float:
    return gap / scale if scale else gap


def _rel_scalar(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b != 0 else (0.0 if a == b else math.inf)


def sample_pairs(seed: int, pairs: int, count: int) -> list[int]:
    """The pairs whose answers are judged, drawn from the seed."""
    if count >= pairs:
        return list(range(pairs))
    rng = np.random.default_rng((seed, 0x636865636b))
    return sorted(int(i) for i in rng.choice(pairs, count, replace=False))


def reference_net(config: dict, module, weights_path: str, device,
                  precision: str = "float32"):
    """The configuration's reference network with the weights of the file
    the program loaded, frozen, in `precision`."""
    net = getattr(module, config["reference_class"])(**config["model"])
    net.load_state_dict(common.read_checkpoint(weights_path))
    net.eval().requires_grad_(False)
    return common.set_precision(net, precision).to(device)


class Pair:
    """One judged pair on the device: padded unit-range images, the zero
    target, and flow functions of a network that unpad."""

    def __init__(self, config, image1, image2, b, device):
        self.pad = common.pad_amounts(config["image_hw"],
                                      config["pad_divisor"],
                                      config["pad_mode"])
        self.i1, self.i2 = (
            common.pad(torch.from_numpy(x[b:b + 1]).to(device), self.pad)
            for x in (image1, image2))
        self.target = torch.zeros((1, *config["image_hw"], 2), device=device)

    def flow_fn(self, net, autocast: str | None = None):
        """`net`'s unpadded flow, in float32; with `autocast`
        ('bfloat16'), under `torch.autocast` to that dtype."""
        def fn(a, b):
            with torch.autocast(a.device.type, dtype=getattr(
                    torch, autocast or "bfloat16"), enabled=bool(autocast)):
                return common.unpad(net(a, b), self.pad).float()
        return fn


def _network_autocast(config: dict) -> str | None:
    p = precision(config)["network"]
    return None if p == "float32" else p


def low_precision_answers(config, traffic, net, image1, image2, pairs,
                          device) -> dict:
    """What the control puts in the program's place: the reference one
    precision step below what the configuration states, part by part
    (`config['control']`: `net` already rounds its products, and runs
    under the configuration's autocast; the L-BFGS history and direction
    in 'optimizer', rounding the direction's projections or, with
    'optimizer_operands' 'all', every operand; the engine's norms in
    'metrics'), in the form the harness gives the program's answers."""
    control = config["control"]
    low = control["metrics"]
    out = {}
    for b in pairs:
        p = Pair(config, image1, image2, b, device)
        fn = p.flow_fn(net, _network_autocast(config))
        with torch.no_grad():
            flow = fn(p.i1, p.i2)
        loss, grad = attack.first_closure(fn, p.i1, p.i2, p.target)
        a = {"flow": flow[0].cpu(), "loss": loss, "grad": grad.cpu()}
        if traffic["attack"] == "pcfa":
            st = attack.pcfa_step(fn, p.i1, p.i2, p.target, traffic,
                                  control["optimizer"], control["optimizer"],
                                  precision(config)["direction"],
                                  control["optimizer_operands"] == "all")
            x1, x2, d1, d2 = st["inputs"]
            a["state"] = {k: st[k] for k in (
                "x", "d", "t", "grad", "steps", "diffs", "h_diag",
                "iterations", "applied")}
        else:
            x1, x2 = attack.fgsm_update(p.i1, p.i2, grad, traffic["epsilon"])
            d1, d2 = x1 - p.i1, x2 - p.i2
            a["delta"] = torch.cat([d1.flatten(), d2.flatten()]).cpu()
        with torch.no_grad():
            f = fn(x1, x2)
        a["flow_step"] = f[0].cpu()
        a["aee"] = float(attack.avg_epe(attack.rounded(f, low), p.target))
        a["l2"] = float(attack.two_norm_avg_delta(
            attack.rounded(d1, low), attack.rounded(d2, low)))
        out[b] = a
    return out


def stopped_after_first(state: dict) -> bool:
    """Whether the L-BFGS segment stopped after its first iteration, which
    it took, with no curvature pair pushed."""
    return (not state["steps"] and state["iterations"] == 1
            and state["applied"])


def _pcfa_numbers(fn, p: Pair, traffic: dict, state: dict, grad_inputs,
                  prec: dict, device) -> tuple[dict, tuple]:
    """The optimizer's numbers of one pair from the program's L-BFGS state
    after the first outer step and its first closure's input gradient
    `grad_inputs`; and the network inputs and δs of its iterate."""
    def dev(t):
        return t.to(device, torch.float32)

    x, d = dev(state["x"]), dev(state["d"])
    steps, diffs = ([dev(t) for t in state[k]] for k in ("steps", "diffs"))
    h = float(state["h_diag"])
    _, x0, split = attack.pcfa_objective(fn, p.i1, p.i2, p.target, traffic)
    stopped = stopped_after_first(state)
    row = {} if stopped else dict.fromkeys(("curvature", "step"), math.inf)
    row.update(first_step=math.inf, iterate=0.0)
    first = steps[0] if steps else state["t"] * d if stopped else None
    if first is not None:
        want = attack.first_step(split, x0, dev(grad_inputs))
        row["first_step"] = _scaled(_rel(first, want), _rel(
            attack.rounded(want, prec["history"]), want))
    if steps:
        s, y = steps[-1].double(), diffs[-1].double()
        row["curvature"] = _rel_scalar(float(s @ y / (y @ y)), h)
    if steps and bool(d.any()):
        direction = attack.DIRECTIONS[prec["direction"]]
        g = dev(state["grad"])
        exact = direction(g.double(), [t.double() for t in steps],
                          [t.double() for t in diffs], h).float()
        at_dtype = direction(g, steps, diffs, h, prec["history"])
        row["step"] = _scaled(_rel(d, exact), _rel(at_dtype, exact))
    if len(steps) == state["iterations"] - 1:
        path = steps + ([state["t"] * d] if state["applied"] else [])
        length = sum(float(torch.linalg.vector_norm(t)) for t in path)
        replay = x0
        for t in path:
            replay = replay + t
        gap = float(torch.linalg.vector_norm((x - replay).double()))
        row["iterate"] = gap / length if length > 0 else math.inf
    return row, split(x)


def _stop(closure_flows, p: Pair, traffic: dict, d1, d2) -> float:
    """|L(x₁) − L(x₀)|: the reference's loss of the flows of the segment's
    first two closures, at x₀ (δ = 0, by the reference's start) and at the
    iterate x₁ (`d1`, `d2`), in float64; infinite without both flows."""
    if len(closure_flows or ()) < 2:
        return math.inf
    f0, f1 = (f.to(p.target.device).double() for f in closure_flows[:2])
    t = p.target[0].double()
    zero = torch.zeros_like(d1, dtype=torch.float64)
    return abs(float(attack.objective(f1, t, d1.double(), d2.double(),
                                      traffic))
               - float(attack.objective(f0, t, zero, zero, traffic)))


def judge(config: dict, traffic: dict, net, image1: np.ndarray,
          image2: np.ndarray, got: dict, device) -> dict[str, float]:
    """The numbers compared, each the worst over the judged pairs `got`
    (the program's answers) on the (P, H, W, 3) unit-range images, with
    the float32 reference `net`."""
    prec = precision(config)
    cast = _network_autocast(config)
    worst: dict[str, float] = {}
    for b, g in got.items():
        p = Pair(config, image1, image2, b, device)
        fn, fn_low = p.flow_fn(net), p.flow_fn(net, cast) if cast else None

        def flow_gap(answer, x1, x2):
            with torch.no_grad():
                want = fn(x1, x2)[0].cpu()
                scale = _rel(fn_low(x1, x2)[0].cpu(), want) if cast else None
            return _scaled(_rel(answer, want), scale)

        loss, grad = attack.first_closure(fn, p.i1, p.i2, p.target)
        scale = None
        if cast:
            scale = _cos_distance(attack.first_closure(
                fn_low, p.i1, p.i2, p.target)[1].cpu(), grad.cpu())
        row = {"flow": flow_gap(g["flow"], p.i1, p.i2),
               "grad": _scaled(_cos_distance(g["grad"], grad.cpu()), scale),
               "loss": _rel_scalar(g["loss"], loss)}
        if traffic["attack"] == "pcfa":
            numbers, (x1, x2, d1, d2) = _pcfa_numbers(
                fn, p, traffic, g["state"], g["grad"], prec, device)
            row.update(numbers)
            if stopped_after_first(g["state"]):
                row["stop"] = _stop(g.get("closure_flows"), p, traffic, d1,
                                    d2)
        else:
            n1, n2 = attack.fgsm_update(p.i1, p.i2, g["grad"].to(device),
                                        traffic["epsilon"])
            want = torch.cat([(n1 - p.i1).flatten(),
                              (n2 - p.i2).flatten()]).cpu()
            row["step"] = float(((g["delta"] - want).abs() > 0)
                                .double().mean())
            n = p.i1.numel()
            delta = g["delta"].to(device)
            d1, d2 = delta[:n].view_as(p.i1), delta[n:].view_as(p.i2)
            x1, x2 = p.i1 + d1, p.i2 + d2
        row["flow_step"] = flow_gap(g["flow_step"], x1, x2)
        aee = float(attack.avg_epe(g["flow_step"].to(device), p.target[0]))
        row["aee"] = _rel_scalar(g["aee"], aee)
        row["l2"] = _rel_scalar(g["l2"],
                                float(attack.two_norm_avg_delta(d1, d2)))
        for k, v in row.items():
            worst[k] = max(worst.get(k, 0.0),
                           v if math.isfinite(v) else math.inf)
    return {k: worst[k] for k in NUMBERS if k in worst}


def verdict(numbers: dict[str, float], limits: dict[str, float],
            failed: int) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}). The configuration's limits name
    the numbers compared; a number without one is shown, with the limit
    null, and not judged. Correct: some number is compared, every compared
    number is at most its limit, and no step of the window failed."""
    shown = {k: {"value": v, "limit": limits.get(k)}
             for k, v in numbers.items()}
    judged = [k for k in numbers if k in limits]
    ok = failed == 0 and bool(judged) and all(numbers[k] <= limits[k]
                                              for k in judged)
    return ok, shown
