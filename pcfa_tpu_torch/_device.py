"""Device resolution for the entry points.

`device="cuda"` is the default everywhere and raises when no GPU is
present; the CPU runs only when the caller asks for it. On the GPU,
float32 means float32: TF32 is switched off for matmuls and cuDNN
convolutions alike (cuDNN's TF32 default keeps ~3 decimal digits).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pcfa_tpu_torch: device='cuda' was requested but CUDA is not "
                "available. Pass device='cpu' to run the plain PyTorch "
                "versions on the CPU.")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"pcfa_tpu_torch: unsupported device {dev}")
    return dev
