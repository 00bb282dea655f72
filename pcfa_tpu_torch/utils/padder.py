"""Input padding to divisor-aligned spatial shapes (`pcfa_tpu/utils/
padder.py`): pad H and W of (..., H, W, C) inputs up to the next multiple
of `divisor` with replicate (edge) padding; 'sintel' mode centers the
padding, other modes pad the bottom only (and center W)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


class InputPadder:
    """Pads (..., H, W, C) tensors or arrays so H, W divide by `divisor`."""

    def __init__(self, dims, divisor: int = 8, mode: str = "sintel"):
        self.ht, self.wd = int(dims[-3]), int(dims[-2])
        pad_ht = (((self.ht // divisor) + 1) * divisor - self.ht) % divisor
        pad_wd = (((self.wd // divisor) + 1) * divisor - self.wd) % divisor
        if mode == "sintel":
            # [w_left, w_right, h_top, h_bottom]
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    @property
    def padded_shape(self) -> tuple[int, int]:
        return (self.ht + self._pad[2] + self._pad[3],
                self.wd + self._pad[0] + self._pad[1])

    def pad(self, *inputs):
        """Replicate-pad each (..., H, W, C) tensor or numpy array."""
        wl, wr, ht, hb = self._pad
        out = []
        for x in inputs:
            if isinstance(x, np.ndarray):
                width = [(0, 0)] * (x.ndim - 3) + [(ht, hb), (wl, wr), (0, 0)]
                out.append(np.pad(x, width, mode="edge"))
                continue
            lead = x.shape[:-3]
            y = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
            y = F.pad(y, (wl, wr, ht, hb), mode="replicate")
            out.append(y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[2:],
                                                     x.shape[-1]))
        return out

    def unpad(self, x):
        """Crop back to the original spatial size."""
        ht, wd = x.shape[-3], x.shape[-2]
        c = [self._pad[2], ht - self._pad[3], self._pad[0], wd - self._pad[1]]
        return x[..., c[0]:c[1], c[2]:c[3], :]
