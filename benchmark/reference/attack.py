"""The attacks' arithmetic in plain float32 PyTorch, one pair at a time.

After Schmalfuss et al., "A Perturbation-Constrained Adversarial Attack
for Evaluating the Robustness of Optical Flow", ECCV 2022
(cv-stuttgart/PCFA `attack_PCFA.py`, `attacks/`): PCFA minimises
AEE(flow, target) + μ·relu(‖δ‖²_avg − bound²) over the two optimizer
variables of a pair with `torch.optim.LBFGS` (lr 1, no line search), whose
`step()` `lbfgs_step` copies, direction (`two_loop`) and stopping rules
included; I-FGSM steps each image against the sign of its gradient.
`flow_fn(x1, x2)` maps padded unit-range (1, H, W, 3) images to the
unpadded flow.
"""

from __future__ import annotations

import torch

from reference import common


def avg_epe(flow, target):
    return torch.sqrt(torch.sum((flow - target) ** 2, dim=-1)).mean()


def two_norm_avg_delta(d1, d2):
    n = d1.numel() + d2.numel()
    return torch.sqrt(torch.sum(d1 ** 2) + torch.sum(d2 ** 2)) / n ** 0.5


def cov_forward(w, eps):
    return 0.5 / (1.0 - eps) * (torch.tanh(w) + (1.0 - eps))


def cov_inverse(x, eps):
    return torch.atanh(2.0 * (1.0 - eps) * x - (1.0 - eps))


def default_mu(bound, target):
    return 2500.0 / bound * (1.0 if target == "zero" else 1.5)


def inputs_and_deltas(w1, w2, image1, image2, boxconstraint, eps):
    """Network inputs and δs of the optimizer variables."""
    if boxconstraint == "change_of_variables":
        x1, x2 = cov_forward(w1, eps), cov_forward(w2, eps)
    else:
        x1, x2 = w1, w2
    x1, x2 = x1.clamp(0, 1), x2.clamp(0, 1)
    return x1, x2, x1 - image1, x2 - image2


def start(image1, image2, boxconstraint, eps):
    if boxconstraint == "change_of_variables":
        return cov_inverse(image1, eps), cov_inverse(image2, eps)
    return image1.clone(), image2.clone()


def first_closure(flow_fn, image1, image2, target):
    """Loss and its gradient with respect to the two network inputs at the
    start (δ = 0), where the penalty is zero."""
    x1 = image1.clone().requires_grad_(True)
    x2 = image2.clone().requires_grad_(True)
    loss = avg_epe(flow_fn(x1, x2), target)
    g1, g2 = torch.autograd.grad(loss, (x1, x2))
    return float(loss.detach()), torch.cat([g1.flatten(), g2.flatten()])


def rounded(x, precision):
    """`x` with its values rounded to `precision` ('float32': unchanged;
    'bfloat16'; 'fp8': e4m3 with a per-tensor scale)."""
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(x.dtype)
    if precision == "fp8":
        return common.rounded(x, "fp8")
    return x


def two_loop(grad, steps, diffs, h_diag, precision="float32",
             throughout=True):
    """torch L-BFGS's direction −H·grad from the curvature pairs (s, y),
    oldest first, with every operand of its products rounded to
    `precision` (`throughout` is the compact form's switch: the recursion
    always rounds them all)."""
    def dot(a, b):
        return torch.dot(rounded(a, precision), rounded(b, precision))

    q = -grad
    al = [None] * len(steps)
    ro = [1.0 / dot(y, s) for s, y in zip(steps, diffs)]
    for i in range(len(steps) - 1, -1, -1):
        al[i] = dot(steps[i], q) * ro[i]
        q = q - al[i] * rounded(diffs[i], precision)
    r = q * h_diag
    for i in range(len(steps)):
        be = dot(diffs[i], r) * ro[i]
        r = r + rounded(steps[i], precision) * (al[i] - be)
    return r


def compact(grad, steps, diffs, h_diag, precision="float32",
            throughout=False):
    """The same direction −H·grad in the compact form of Byrd, Nocedal and
    Schnabel (1994), which `PCFA_LBFGS_DIRECTION=compact` states: with
    R = triu(SᵀY), D = diag(SᵀY), γ = `h_diag`,
        H·g = γg + S·R⁻ᵀ(D + γYᵀY)R⁻¹Sᵀg − γS·R⁻ᵀYᵀg − γY·R⁻¹Sᵀg.
    Its projections Sᵀg and Yᵀg are taken of `grad` rounded to
    `precision`, as an L-BFGS whose history is kept in that dtype forms
    them; `throughout` rounds every product's operands and the small
    solves' inputs too, a direction computed in that precision."""
    def r(x):
        return rounded(x, precision) if throughout else x

    if not steps:
        return -h_diag * grad
    S, Y = r(torch.stack(steps, 1)), r(torch.stack(diffs, 1))
    g = rounded(grad, precision)
    sy, yy = r(S.T @ Y), r(Y.T @ Y)
    tri = torch.triu(sy)
    q = r(torch.linalg.solve_triangular(tri, r(S.T @ g)[:, None],
                                        upper=True))
    t = r(torch.diagonal(sy)[:, None] * q + h_diag * (yy @ q)
          - h_diag * r(Y.T @ g)[:, None])
    top = r(torch.linalg.solve_triangular(tri.T, t, upper=False))
    return -(h_diag * grad + S @ top[:, 0] - h_diag * (Y @ q[:, 0]))


DIRECTIONS = {"two_loop": two_loop, "compact": compact}


def lbfgs_step(closure, x, max_iter, history_size, lr=1.0,
               tolerance_grad=1e-7, tolerance_change=1e-9,
               precision="float32", store="float32", direction="two_loop",
               throughout=True):
    """One `step()` of `torch.optim.LBFGS` without line search, from a
    fresh state: `closure(x)` gives (loss, gradient). The direction
    (`DIRECTIONS`) takes its products in `precision` (the compact form:
    its projections only, or with `throughout` every operand), and the
    curvature pairs are stored rounded to `store`. Returns the state after
    it: {x, d, t, grad (the gradient `d` was computed from), steps, diffs,
    h_diag, iterations, applied (whether x took the step t·d)}."""
    max_eval = max_iter * 5 // 4
    loss, g = closure(x)
    state = {"x": x, "d": -g, "t": 0.0, "grad": g, "steps": [],
             "diffs": [], "h_diag": 1.0, "iterations": 0, "applied": False}
    if g.abs().max() <= tolerance_grad:
        return state
    d, t, prev_g, h_diag, evals = None, None, None, 1.0, 1
    steps, diffs = [], []
    for n_iter in range(1, max_iter + 1):
        if n_iter == 1:
            d = -g
        else:
            y, s = g - prev_g, d * t
            ys = torch.dot(y, s)
            if ys > 1e-10:
                if len(steps) == history_size:
                    steps.pop(0)
                    diffs.pop(0)
                steps.append(rounded(s, store))
                diffs.append(rounded(y, store))
                h_diag = float(ys / torch.dot(y, y))
            d = DIRECTIONS[direction](g, steps, diffs, h_diag, precision,
                                      throughout=throughout)
        prev_g, prev_loss = g, loss
        t = min(1.0, 1.0 / float(g.abs().sum())) * lr if n_iter == 1 else lr
        state.update(d=d, t=t, grad=g, steps=list(steps), diffs=list(diffs),
                     h_diag=h_diag, iterations=n_iter, applied=False)
        if torch.dot(g, d) > -tolerance_change:
            break
        x = x + t * d
        state.update(x=x, applied=True)
        if n_iter == max_iter:
            break
        loss, g = closure(x)
        evals += 1
        if evals >= max_eval or g.abs().max() <= tolerance_grad \
                or (d * t).abs().max() <= tolerance_change \
                or abs(loss - prev_loss) < tolerance_change:
            break
    return state


def objective(flow, target, d1, d2, t):
    """PCFA's loss of one pair: AEE(flow, target) + μ·relu(‖δ‖²_avg −
    bound²), with the traffic `t`'s μ (by default 2500/bound)."""
    mu = t["mu"] if t.get("mu") is not None else default_mu(
        t["delta_bound"], t["target"])
    excess = (torch.sum(d1 ** 2) + torch.sum(d2 ** 2)) / (
        d1.numel() + d2.numel()) - t["delta_bound"] ** 2
    return avg_epe(flow, target) + mu * torch.relu(excess)


def pcfa_objective(flow_fn, image1, image2, target, t):
    """(closure over the flat optimizer variable of one pair, its start,
    and the map from the variable to (network inputs, δs))."""
    eps = t["eps_box"]
    w1, w2 = start(image1, image2, t["boxconstraint"], eps)
    n = w1.numel()

    def split(v):
        return inputs_and_deltas(v[:n].view_as(w1), v[n:].view_as(w2),
                                 image1, image2, t["boxconstraint"], eps)

    def closure(v):
        v = v.detach().requires_grad_(True)
        x1, x2, d1, d2 = split(v)
        loss = objective(flow_fn(x1, x2), target, d1, d2, t)
        (g,) = torch.autograd.grad(loss, v)
        return float(loss.detach()), g

    return closure, torch.cat([w1.flatten(), w2.flatten()]), split


def first_step(split, x0, grad_inputs):
    """The first L-BFGS iteration's step −min(1, 1/‖g‖₁)·g in the optimizer
    variable at its start `x0` (`pcfa_objective`'s `split` and start), from
    the loss's gradient with respect to the two network inputs there (flat,
    concatenated): δ = 0, so the penalty adds nothing."""
    v = x0.detach().requires_grad_(True)
    x1, x2, _, _ = split(v)
    n = x1.numel()
    (g,) = torch.autograd.grad((x1, x2), v, (grad_inputs[:n].view_as(x1),
                                              grad_inputs[n:].view_as(x2)))
    return -min(1.0, 1.0 / float(g.abs().sum())) * g


def pcfa_step(flow_fn, image1, image2, target, t, precision="float32",
              store="float32", direction="two_loop", throughout=True):
    """One outer step of PCFA from δ = 0 for one pair: the L-BFGS state
    after it (`lbfgs_step`) with the network inputs and δs of its
    iterate."""
    closure, x0, split = pcfa_objective(flow_fn, image1, image2, target, t)
    state = lbfgs_step(closure, x0, t["max_iter"], t["history_size"],
                       precision=precision, store=store, direction=direction,
                       throughout=throughout)
    with torch.no_grad():
        state["inputs"] = split(state["x"])
    return state


def fgsm_update(image1, image2, grad, epsilon):
    """One I-FGSM step of the two network inputs against the sign of
    their (flat, concatenated) gradient: the new inputs."""
    n = image1.numel()
    g1, g2 = grad[:n].view_as(image1), grad[n:].view_as(image2)
    return ((image1 - epsilon * torch.sign(g1)).clamp(0, 1),
            (image2 - epsilon * torch.sign(g2)).clamp(0, 1))
