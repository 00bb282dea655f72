"""Sampling, warping, resizing and pooling primitives (channels-last
public layout, like `pcfa_tpu/ops/warp.py`): images (B, H, W, C), point
grids (B, Hg, Wg, 2) with (x, y) in the last axis.

`grid_sample` is the JAX package's packed-corner sampler: one row gather
of each sample's 2×2 window, and a backward (d img, d ix, d iy) that is one
call of `ops/segsum.warp_bwd` (a CUDA kernel on the card). `resample2d`,
FlowNet2's warp, is the same sampler in border mode."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pcfa_tpu_torch.ops.segsum import warp_bwd


def coords_grid(batch: int, ht: int, wd: int,
                device: str | torch.device | None = None) -> torch.Tensor:
    """Pixel-coordinate grid (B, H, W, 2), float32, (x, y) channels."""
    y, x = torch.meshgrid(torch.arange(ht, device=device),
                          torch.arange(wd, device=device), indexing="ij")
    coords = torch.stack([x, y], dim=-1).to(torch.float32)
    return coords[None].expand(batch, ht, wd, 2)


def avg_pool2d(img: torch.Tensor, window: int = 2,
               stride: int | None = None) -> torch.Tensor:
    """Average pooling on (B, H, W, C), VALID padding (odd sizes floor:
    47 → 23 → 11 → 5)."""
    stride = stride or window
    out = F.avg_pool2d(img.permute(0, 3, 1, 2), window, stride)
    return out.permute(0, 2, 3, 1)


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """RAFT-style sampling at absolute pixel coordinates: normalize with
    align_corners=True, grid-sample with zero padding.

    img: (B, H, W, C); coords: (B, Hg, Wg, 2) → (B, Hg, Wg, C)."""
    # at least float32 (a bf16 grid cannot hold pixel positions); float64
    # stays float64, so a float64 model is float64 end to end
    dt = torch.promote_types(img.dtype, torch.float32)
    H, W = img.shape[1], img.shape[2]
    coords = coords.to(dt)
    xgrid = 2.0 * coords[..., 0] / (W - 1) - 1.0
    ygrid = 2.0 * coords[..., 1] / (H - 1) - 1.0
    grid = torch.stack([xgrid, ygrid], dim=-1)
    out = F.grid_sample(img.permute(0, 3, 1, 2).to(dt), grid,
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.permute(0, 2, 3, 1).to(img.dtype)


def _corner_weights(img_shape, ix: torch.Tensor, iy: torch.Tensor,
                    zeros: bool):
    """Coordinate machinery of the packed-corner sampler
    (`pcfa_tpu/ops/warp.py:_corner_weights`).

    Returns (idx, w4, mask4, a, b): `idx` (N,) flat-indexes the
    (B, H+1, W+1) grid of window bases in the edge-replicated pad, `w4`
    (N, 4) the bilinear weights in slot order tl, tr, bl, br, `mask4`
    (N, 4) the zeros-mode corner validity (None in border mode), `a`, `b`
    the fractional offsets. The window base is clipped to [−1, dim−1], so
    an out-of-range corner reads, and in the backward accumulates onto,
    the border cell a per-corner clamp would use; NaN coordinates take
    base −1 and, in zeros mode, zero weights."""
    B, H, W, _ = img_shape
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    a = ix - x0
    b = iy - y0
    r0 = torch.clamp(torch.nan_to_num(y0, nan=-1.0), -1, H - 1).long() + 1
    c0 = torch.clamp(torch.nan_to_num(x0, nan=-1.0), -1, W - 1).long() + 1
    N = r0.numel()
    brow = (torch.arange(B, device=ix.device) * (H + 1)).view(
        B, *([1] * (ix.dim() - 1)))
    idx = ((brow + r0) * (W + 1) + c0).reshape(N)
    wx = torch.stack([1.0 - a, a], dim=-1)
    wy = torch.stack([1.0 - b, b], dim=-1)
    w4 = (wy[..., :, None] * wx[..., None, :]).reshape(N, 4)
    mask4 = None
    if zeros:
        vx = torch.stack([(x0 >= 0) & (x0 < W), (x0 + 1 >= 0) & (x0 + 1 < W)],
                         dim=-1)
        vy = torch.stack([(y0 >= 0) & (y0 < H), (y0 + 1 >= 0) & (y0 + 1 < H)],
                         dim=-1)
        mask4 = (vy[..., :, None] & vx[..., None, :]).reshape(N, 4)
        w4 = torch.where(mask4, w4, torch.zeros((), dtype=w4.dtype,
                                                device=w4.device))
    return idx, w4, mask4, a, b


def _pack_windows(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B·(H+1)·(W+1), 4C): row (b, r, c) holds the 2×2
    window at base (r, c) of the edge-replicated pad, corners in slot
    order."""
    B, H, W, C = img.shape
    p = F.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    p = p.permute(0, 2, 3, 1)
    win4 = torch.cat([p[:, :-1, :-1], p[:, :-1, 1:], p[:, 1:, :-1],
                      p[:, 1:, 1:]], dim=-1)
    return win4.reshape(B * (H + 1) * (W + 1), 4 * C)


class _PackedBilinear(torch.autograd.Function):
    """Bilinear sample of `img` (B, H, W, C) at absolute pixel coordinates
    `ix`, `iy` (B, Hg, Wg): the forward and custom VJP of
    `pcfa_tpu/ops/warp.py:_bilinear_abs_packed`. The output takes the
    promoted dtype of image and coordinates, as in the JAX package. The
    backward is `ops/segsum.warp_bwd` on the saved state, in float32
    (float64 for float64 inputs): d img adds each corner's w·g onto its
    clamped cell (on the CPU: a segment row-sum of the 4C-wide corner
    rows, four shifted adds and the border folds); d ix, d iy come from
    the saved corner values."""

    @staticmethod
    def forward(ctx, img, ix, iy, zeros):
        B, H, W, C = img.shape
        idx, w4, mask4, a, b = _corner_weights(img.shape, ix, iy, zeros)
        win = _pack_windows(img)[idx].reshape(-1, 4, C)
        rt = torch.promote_types(img.dtype, ix.dtype)
        out = (w4.to(rt)[:, :, None] * win.to(rt)).sum(1)
        ctx.img_shape, ctx.img_dtype = img.shape, img.dtype
        ctx.save_for_backward(win, idx, w4, mask4, a, b)
        return out.reshape(*ix.shape, C)

    @staticmethod
    def backward(ctx, g):
        win, idx, w4, mask4, a, b = ctx.saved_tensors
        dimg, dix, diy = warp_bwd(
            g, win, idx, w4, mask4, a, b, ctx.img_shape, ctx.img_dtype,
            ctx.needs_input_grad[0],
            ctx.needs_input_grad[1] or ctx.needs_input_grad[2])
        return dimg, dix, diy, None


def _clip(x: torch.Tensor, hi: float) -> torch.Tensor:
    """x clipped to [0, hi] as `jnp.clip` clips it: max with 0, then min
    with hi, so the derivative exactly on either bound is ½
    (`torch.clamp`'s is 1). The bounds are 0-dim CPU tensors, which a CUDA
    operand takes as scalars."""
    zero = torch.zeros((), dtype=x.dtype)
    return torch.minimum(torch.maximum(x, zero), zero + hi)


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = False,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sampling with torch `F.grid_sample` semantics on
    channels-last tensors, through the packed-corner sampler.

    img: (B, H, W, C); grid: (B, Hg, Wg, 2) in [−1, 1], (x, y) order.
    Returns (B, Hg, Wg, C) in the promoted dtype of img and grid. In
    border mode the pixel coordinates are clipped by `_clip`, so d grid
    exactly on the edge is ½ of the slope inside, as `pcfa_tpu`'s."""
    B, H, W, C = img.shape
    x, y = grid[..., 0], grid[..., 1]
    if align_corners:
        ix = (x + 1.0) * 0.5 * (W - 1)
        iy = (y + 1.0) * 0.5 * (H - 1)
    else:
        ix = ((x + 1.0) * W - 1.0) * 0.5
        iy = ((y + 1.0) * H - 1.0) * 0.5
    if padding_mode == "border":
        ix, iy = _clip(ix, W - 1), _clip(iy, H - 1)
    elif padding_mode != "zeros":
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    return _PackedBilinear.apply(img, ix, iy, padding_mode == "zeros")


def resample2d(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """FlowNet2's warp (`pcfa_tpu/ops/warp.py:resample2d`): out(x, y) =
    bilinear(img at (x + u, y + v)), each corner's index clamped to the
    image with the weights of the unclamped fractions (the packed sampler
    in border mode; not `grid_sample`'s border mode, which clamps the
    coordinate). img (B, H, W, C), flow (B, H, W, 2) → (B, H, W, C) in
    the promoted dtype, at least float32. The pixel grid is float32
    (float64 for float64 inputs); the JAX package builds it in the image's
    dtype, which under bf16 rounds x > 256 (ROADMAP.md §3)."""
    B, H, W, _ = img.shape
    dt = torch.promote_types(torch.promote_types(img.dtype, flow.dtype),
                             torch.float32)
    xs = torch.arange(W, dtype=dt, device=img.device)
    ys = torch.arange(H, dtype=dt, device=img.device)
    gx = xs[None, None, :] + flow[..., 0].to(dt)
    gy = ys[None, :, None] + flow[..., 1].to(dt)
    return _PackedBilinear.apply(img, gx, gy, False)


def interpolate_bilinear(img: torch.Tensor, out_hw: tuple[int, int],
                         align_corners: bool = False) -> torch.Tensor:
    """torch `F.interpolate(mode='bilinear')` on (B, H, W, C), computed in
    float32 at least (the JAX package's float32 resize matrices promote a
    bf16 image the same way)."""
    dt = torch.promote_types(img.dtype, torch.float32)
    out = F.interpolate(img.permute(0, 3, 1, 2).to(dt), size=tuple(out_hw),
                        mode="bilinear", align_corners=align_corners)
    return out.permute(0, 2, 3, 1)


def upflow(flow: torch.Tensor, factor: int = 8,
           align_corners: bool = True) -> torch.Tensor:
    """A flow field (B, H, W, 2) upsampled by `factor` and its magnitude
    scaled with it (the reference RAFT's `upflow8`), in float32 at least."""
    _, H, W, _ = flow.shape
    return factor * interpolate_bilinear(flow, (factor * H, factor * W),
                                         align_corners)
