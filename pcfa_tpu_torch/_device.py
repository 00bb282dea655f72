"""Device resolution for the entry points.

`device="cuda"` is the default everywhere and raises when no GPU is
present; the CPU runs only when the caller asks for it. The precision of
float32 products on the GPU is `config.RuntimeConfig`'s: the first CUDA
device resolved in a process where none was applied yet applies the
default, 'highest' (TF32 off for matmuls and cuDNN convolutions alike;
cuDNN's own TF32 default keeps ~3 decimal digits).
"""

from __future__ import annotations

import torch

from pcfa_tpu_torch.config import ensure_runtime_config


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pcfa_tpu_torch: device='cuda' was requested but CUDA is not "
                "available. Pass device='cpu' to run the plain PyTorch "
                "versions on the CPU.")
        ensure_runtime_config()
    elif dev.type != "cpu":
        raise ValueError(f"pcfa_tpu_torch: unsupported device {dev}")
    return dev
