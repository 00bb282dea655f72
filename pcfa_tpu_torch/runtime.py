"""Model runtime (`pcfa_tpu/runtime.py`): load a flow network and build
the attack-facing flow function.

    loaded = load_model("RAFT", init_random=True, seed=0)   # on CUDA
    padder, flow_fn = make_flow_fn(loaded, (H, W))

`flow_fn(x1, x2)` takes padded unit-range (B, H', W', 3) images and
returns the unpadded float32 flow (B, H, W, 2), the quantity entering the
attack loss. Checkpoint loading waits until reference weights are in the
repository; `init_random=True` builds deterministic random weights from a
`torch.Generator` with flax's default initializers (truncated-normal
LeCun kernels, zero biases, unit BatchNorm scales).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable

import torch
import torch.nn as nn

from pcfa_tpu_torch._device import resolve_device
from pcfa_tpu_torch.config import compute_dtype
from pcfa_tpu_torch.models import make_model
from pcfa_tpu_torch.utils.padder import InputPadder

# stddev of a unit-variance normal truncated to ±2 (flax lecun_normal)
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass
class LoadedModel:
    name: str
    module: nn.Module
    spec: object
    device: torch.device


def init_random_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Flax-default random init, in place, from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("weight") and p.dim() == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                t = torch.empty(p.shape, dtype=torch.float32)
                nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                p.copy_(t)
            elif name.endswith("scale"):
                p.fill_(1.0)
            else:
                p.zero_()
    return module


def load_model(name: str = "RAFT", checkpoint: str | None = None,
               init_random: bool = False, seed: int = 0,
               device: str | torch.device = "cuda",
               **overrides) -> LoadedModel:
    """Build the frozen (eval, no parameter gradients) module for `name`
    on `device`. Random weights need `init_random=True`."""
    dev = resolve_device(device)
    module, spec = make_model(name, **overrides)
    if checkpoint is not None or not init_random:
        raise FileNotFoundError(
            f"Loading {name} weights from a checkpoint is not ported yet "
            f"(no reference weights in the repository; checkpoint="
            f"{checkpoint!r}). Pass init_random=True for deterministic "
            f"random weights.")
    init_random_(module, seed)
    module.eval().requires_grad_(False).to(dev)
    return LoadedModel(name=name, module=module, spec=spec, device=dev)


def make_flow_fn(loaded: LoadedModel, image_hw: tuple[int, int],
                 pad_mode: str = "sintel") -> tuple[InputPadder, Callable]:
    """(padder, flow_fn). PCFA_COMPUTE_DTYPE=bfloat16 runs the network's
    weights and inputs in bf16 (a cast copy of the module) while coords,
    flow and the returned `flow_up` stay float32."""
    H, W = image_hw
    padder = InputPadder((H, W, 3), divisor=loaded.spec.pad_divisor,
                         mode=pad_mode)
    cdtype = compute_dtype()
    module = loaded.module
    if cdtype is not None:
        module = copy.deepcopy(module).to(cdtype)

    def flow_fn(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if cdtype is not None:
            x1, x2 = x1.to(cdtype), x2.to(cdtype)
        out = module(x1, x2)
        if isinstance(out, tuple):
            out = out[-1]
        return padder.unpad(out.to(torch.float32))

    return padder, flow_fn
