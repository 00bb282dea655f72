"""Box-constraint parameterizations (`pcfa_tpu/attack/boxconstraint.py`):
clipping (optimize the network input, δ = clip(x, 0, 1) − image) or
change of variables (tanh space), and the joint-mode double clamp.

Every clip to [0, 1] is `clip01`, max then min, as `jnp.clip`: its
derivative exactly on a bound is ½ (`torch.clamp`'s is 1). Real frames
(uint8 / 255) hold exact 0s and 1s, and the attack starts at the images,
so the bound is met from the first closure on."""

from __future__ import annotations

import torch

EPS_BOX_DEFAULT = 1e-7


def clip01(x: torch.Tensor) -> torch.Tensor:
    """x clipped to [0, 1] as `jnp.clip` clips it: max with 0, then min
    with 1, so the derivative is ½ at x = 0 and at x = 1. The bounds are
    0-dim CPU tensors, which a CUDA operand takes as scalars (no launch)."""
    zero = torch.zeros((), dtype=x.dtype)
    return torch.minimum(torch.maximum(x, zero), zero + 1)


def cov_forward(w: torch.Tensor, eps_box: float = EPS_BOX_DEFAULT):
    """w → 0.5/(1-ε)·(tanh(w) + (1-ε)), in (0, 1)."""
    return 0.5 / (1.0 - eps_box) * (torch.tanh(w) + (1.0 - eps_box))


def cov_inverse(x: torch.Tensor, eps_box: float = EPS_BOX_DEFAULT):
    """image space → w: atanh(2(1-ε)x − (1-ε))."""
    return torch.atanh(2.0 * (1.0 - eps_box) * x - (1.0 - eps_box))


def extract_deltas(nw_input1, nw_input2, image1, image2, boxconstraint: str,
                   eps_box: float = 0.0):
    """(δ1, δ2) from the optimizer variables."""
    if boxconstraint == "change_of_variables":
        return (cov_forward(nw_input1, eps_box) - image1,
                cov_forward(nw_input2, eps_box) - image2)
    return clip01(nw_input1) - image1, clip01(nw_input2) - image2


def extract_deltas_joint(nw_delta, images_max, images_min):
    """Joint-mode effective δ via the double clamp."""
    delta_upper = clip01(nw_delta + images_max) - images_max
    delta = clip01(delta_upper + images_min) - images_min
    return delta, delta


def init_nw_inputs(image1, image2, boxconstraint: str,
                   eps_box: float = EPS_BOX_DEFAULT):
    """Initial optimizer variables for δ = 0."""
    if boxconstraint == "change_of_variables":
        return cov_inverse(image1, eps_box), cov_inverse(image2, eps_box)
    return image1, image2


def perturbed_images(nw_input1, nw_input2, boxconstraint: str,
                     eps_box: float = EPS_BOX_DEFAULT):
    """Optimizer variables → in-range network inputs: the COV transform if
    configured, then clip to [0, 1]."""
    if boxconstraint == "change_of_variables":
        nw_input1 = cov_forward(nw_input1, eps_box)
        nw_input2 = cov_forward(nw_input2, eps_box)
    return clip01(nw_input1), clip01(nw_input2)
