"""Random weights from a seed, in a network's published checkpoint layout.

The layout is the reference network's own state dict (`reference/<net>.py`
builds the published module names), so the file the program loads is
the file a user of the published network would pass as its checkpoint.
Values are drawn on the device by one `torch.Generator`, in two calls
(normal and uniform) over every tensor at once, then shaped:

* convolution weights: normal, std 1/√fan_in (fan_in = input channels ×
  taps; a transposed convolution's input channels are its first axis);
* biases: normal, std `bias_std`;
* BatchNorm: weight 1 + 0.2·normal, bias as above, running mean
  0.1·normal, running variance 0.5 + uniform[0, 1), 1000 batches seen;
* the keys of `scale` multiplied by their factor (RAFT's flow head is
  damped, as the repository's parity tests damp it, so that 12
  refinement iterations of a random network stay near the image).
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn as nn


def layout(module: nn.Module) -> dict[str, tuple[torch.Size, str]]:
    """{key: (shape, kind)} of `module`'s state dict; kind is 'conv',
    'deconv', 'bias', 'bn_weight', 'bn_mean', 'bn_var', 'bn_count' or
    'other'."""
    kinds = {}
    for prefix, m in module.named_modules():
        p = f"{prefix}." if prefix else ""
        if isinstance(m, nn.ConvTranspose2d):
            kinds[f"{p}weight"] = "deconv"
        elif isinstance(m, nn.Conv2d):
            kinds[f"{p}weight"] = "conv"
        elif isinstance(m, nn.BatchNorm2d):
            kinds.update({f"{p}weight": "bn_weight",
                          f"{p}running_mean": "bn_mean",
                          f"{p}running_var": "bn_var",
                          f"{p}num_batches_tracked": "bn_count"})
    out = {}
    for k, v in module.state_dict().items():
        kind = kinds.get(k, "bias" if k.endswith(".bias") else "other")
        out[k] = (v.shape, kind)
    return out


def make(module: nn.Module, seed: int, device, bias_std: float = 0.05,
         scale: dict | None = None) -> dict[str, torch.Tensor]:
    """A state dict for `module`'s layout (CPU tensors, float32)."""
    spec = layout(module)
    sizes = [math.prod(s) for s, _ in spec.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (key, (shape, kind)), n in zip(spec.items(), sizes):
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if kind in ("conv", "deconv"):
            c_in = shape[0] if kind == "deconv" else shape[1]
            w = z / math.sqrt(c_in * math.prod(shape[2:]))
        elif kind == "bias":
            w = bias_std * z
        elif kind == "bn_weight":
            w = 1.0 + 0.2 * z
        elif kind == "bn_mean":
            w = 0.1 * z
        elif kind == "bn_var":
            w = 0.5 + u
        elif kind == "bn_count":
            out[key] = torch.tensor(1000)
            continue
        else:
            raise ValueError(f"no rule for the weights of {key}")
        out[key] = w
    for prefix, factor in (scale or {}).items():
        for key in out:
            if key.startswith(prefix + "."):
                out[key] = out[key] * factor
    return {k: v.to("cpu", torch.float32) if v.is_floating_point() else v
            for k, v in out.items()}


def save(state: dict[str, torch.Tensor], path: str, container: str) -> str:
    """Write `state` as the published file does: 'module' prefixes every
    key with `module.` (a DataParallel state: RAFT), 'state_dict' wraps it
    as {'state_dict': …} (PWCNet)."""
    if container == "module":
        obj = {f"module.{k}": v for k, v in state.items()}
    elif container == "state_dict":
        obj = {"state_dict": state}
    else:
        raise ValueError(f"unknown checkpoint container {container!r}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(obj, path)
    return path
