"""Box-constraint parameterizations (`pcfa_tpu/attack/boxconstraint.py`):
clipping (optimize the network input, δ = clamp(x, 0, 1) − image) or
change of variables (tanh space), and the joint-mode double clamp."""

from __future__ import annotations

import torch

EPS_BOX_DEFAULT = 1e-7


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
    return (torch.clamp(nw_input1, 0.0, 1.0) - image1,
            torch.clamp(nw_input2, 0.0, 1.0) - image2)


def extract_deltas_joint(nw_delta, images_max, images_min):
    """Joint-mode effective δ via the double clamp."""
    delta_upper = torch.clamp(nw_delta + images_max, 0.0, 1.0) - images_max
    delta = torch.clamp(delta_upper + images_min, 0.0, 1.0) - images_min
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
    configured, then clamp to [0, 1]."""
    if boxconstraint == "change_of_variables":
        nw_input1 = cov_forward(nw_input1, eps_box)
        nw_input2 = cov_forward(nw_input2, eps_box)
    return torch.clamp(nw_input1, 0.0, 1.0), torch.clamp(nw_input2, 0.0, 1.0)
