"""Image pairs made from a seed: the port's procedural generator
(`pcfa_tpu_torch/data/synthetic.py`), frozen here so that the benchmark's
inputs cannot move with the program.

A pair is a smooth random texture (coarse uniform noise on a grid 8×
coarser, bilinearly upsampled) and the same texture rolled by a whole
pixel shift of at most `max_shift` in each axis. The upsampling is the
original's bilinear blend, done one axis at a time (rows, then columns),
which costs a tenth of the original's four full-size gathers. Images are
unit-range float32 (H, W, 3); (seed, index) fixes the pair.
"""

from __future__ import annotations

import numpy as np


def _axis(n_out: int, n_in: int):
    pos = np.linspace(0, n_in - 1, n_out)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    return lo, hi, (pos - lo).astype(np.float32)


def smooth_noise(rng: np.random.Generator, h: int, w: int,
                 c: int = 3) -> np.ndarray:
    ch, cw = max(2, h // 8), max(2, w // 8)
    coarse = rng.random((ch, cw, c)).astype(np.float32)
    y0, y1, fy = _axis(h, ch)
    x0, x1, fx = _axis(w, cw)
    rows = coarse[y0] * (1 - fy)[:, None, None] + coarse[y1] * fy[:, None,
                                                                    None]
    return rows[:, x0] * (1 - fx)[None, :, None] + rows[:, x1] * fx[None, :,
                                                                    None]


def pair(seed: int, index: int, size: tuple[int, int],
         max_shift: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """(image1, image2), unit-range float32 (H, W, 3)."""
    h, w = size
    rng = np.random.default_rng((seed, index))
    img1 = smooth_noise(rng, h, w)
    u = int(rng.integers(-max_shift, max_shift + 1))
    v = int(rng.integers(-max_shift, max_shift + 1))
    return img1, np.roll(img1, shift=(v, u), axis=(0, 1))


def batch(seed: int, first: int, count: int, size: tuple[int, int],
          max_shift: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Pairs `first` … `first + count − 1`, stacked: two (count, H, W, 3)."""
    pairs = [pair(seed, first + i, size, max_shift) for i in range(count)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))
