"""Procedural flow dataset with analytic ground truth.

The port's own copy of `pcfa_tpu/data/synthetic.py`: the same
(seed, index) gives the same frames, byte for byte.

Each sample is a smooth random texture translated by a constant per-sample
flow (integer shifts, so frame 2 is an exact roll of frame 1 and the GT flow
is exact). Deterministic per (seed, index); no files needed. Serves as the
CI stand-in for KITTI/Sintel (SURVEY.md §4 item 3) and as the `Synthetic`
CLI dataset option.
"""

from __future__ import annotations

import numpy as np


def _smooth_noise(rng: np.random.Generator, h: int, w: int, c: int = 3) -> np.ndarray:
    """Band-limited noise in [0,1]: bilinear-upsampled coarse noise."""
    ch, cw = max(2, h // 8), max(2, w // 8)
    coarse = rng.random((ch, cw, c)).astype(np.float32)
    ys = np.linspace(0, ch - 1, h)
    xs = np.linspace(0, cw - 1, w)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, ch - 1)
    x1 = np.minimum(x0 + 1, cw - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    img = (
        coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
        + coarse[np.ix_(y0, x1)] * (1 - fy) * fx
        + coarse[np.ix_(y1, x0)] * fy * (1 - fx)
        + coarse[np.ix_(y1, x1)] * fy * fx
    )
    return img.astype(np.float32)


class SyntheticDataset:
    """Indexable dataset of (img1, img2, flow_gt, valid) in reference layout.

    Images are float32 (H, W, 3) in **[0, 255]** (like the file loaders,
    `datasets.py:79-88`); flow is float32 (H, W, 2); valid is float32 (H, W).
    """

    def __init__(
        self,
        num_samples: int = 32,
        size: tuple[int, int] = (128, 256),
        max_shift: int = 8,
        seed: int = 0,
        has_gt: bool = True,
    ):
        self.num_samples = num_samples
        self.size = size
        self.max_shift = max_shift
        self.seed = seed
        self._has_gt = has_gt

    def has_groundtruth(self) -> bool:
        return self._has_gt

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int):
        if not 0 <= idx < self.num_samples:
            raise IndexError(idx)
        h, w = self.size
        rng = np.random.default_rng((self.seed, idx))
        img1 = _smooth_noise(rng, h, w) * 255.0
        u = int(rng.integers(-self.max_shift, self.max_shift + 1))
        v = int(rng.integers(-self.max_shift, self.max_shift + 1))
        # backward-warp convention: img2(x) = img1(x - f) ⇒ img2 = roll(img1, +f)
        img2 = np.roll(img1, shift=(v, u), axis=(0, 1))
        flow = np.zeros((h, w, 2), np.float32)
        flow[..., 0] = u
        flow[..., 1] = v
        if self._has_gt:
            valid = np.ones((h, w), np.float32)
        else:
            flow = np.zeros_like(flow)
            valid = np.zeros((h, w), np.float32)
        return img1, img2, flow, valid
