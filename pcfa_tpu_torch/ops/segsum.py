"""The packed sampler's backward (the warp's d img, d ix, d iy): CUDA
kernel, launch counter and plain version.

Replaces the Pallas kernel of `pcfa_tpu/ops/pallas/segsum.py`
(`segment_rows_pallas`), the segment row-sum

    out[p] = Σ_{i : idx[i] = p} upd[i]     (N, 4C) corner rows into cells

that carries the JAX package's image gradient of the packed-corner sampler
(`pcfa_tpu/ops/warp.py:_bilinear_abs_packed_bwd`). Its sorted, blocked
one-hot matmul plan works around a TPU's serial scatter and is not carried
over. The kernel (`csrc/segsum.cu`) computes that whole backward in one
launch from the saved forward state: each corner's w·g goes by a float32
atomic add straight to its clamped cell of the image gradient (what the
row-sum, four shifted adds and border folds compute), and d ix, d iy come
from the four corner dots in the same pass over g.

`warp_bwd_plain` is that composition in plain PyTorch (`segment_rows_plain`,
the shifted adds, the folds and the dot formulas): the CPU path and the
kernel's oracle. It computes in float32 (float64 for a float64 cotangent).
The kernel takes float32 g and coordinates (bf16 ones are widened first)
and a float32 or bf16 image; it raises for any other dtype. Atomics add in
an order that changes from run to run, so d img differs from the plain
version by float32 rounding.

Bound on the H100: bytes (inputs read once, outputs written once); PWCNet's
level-2 warp at 384×1280 (N = 30,720, C = 32, bf16 image) moves ~15 MB.

CPU tensors go to the plain version; CUDA tensors launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pcfa_tpu_torch.ops import _build
from pcfa_tpu_torch.utils import profiling

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "pcfa_warp_bwd": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                      ctypes.c_int64, _I, _I, _I, _I, _I, _I, _P],
}


def segment_rows_plain(idx: torch.Tensor, upd: torch.Tensor,
                       nrows: int) -> torch.Tensor:
    """Σ of `upd` rows per cell, (nrows, K): `index_add_` into a float32
    (float64 for float64 rows) zero buffer, in `upd`'s dtype."""
    dt = torch.promote_types(upd.dtype, torch.float32)
    out = torch.zeros((nrows, upd.shape[1]), dtype=dt, device=upd.device)
    return out.index_add_(0, idx, upd.to(dt)).to(upd.dtype)


def warp_bwd_plain(g, win, idx, w4, mask4, a, b, img_shape, img_dtype,
                   need_img: bool = True, need_grid: bool = True):
    """Plain version of the sampler's backward. `g` holds N·C cotangent
    values; `win` (N, 4, C), `idx` (N,), `w4` (N, 4), `mask4` (N, 4) or
    None and `a`, `b` (N elements) are the forward's saved state
    (`ops/warp._corner_weights`). Returns (d img (B, H, W, C) in
    `img_dtype`, d ix, d iy in `a`'s shape and dtype), None for a part not
    asked for."""
    B, H, W, C = img_shape
    N = w4.shape[0]
    dt = torch.promote_types(g.dtype, torch.float32)
    gf = g.reshape(N, C).to(dt)
    dimg = dix = diy = None
    if need_img:
        upd = (w4.to(dt)[:, :, None] * gf[:, None, :]).reshape(N, 4 * C)
        buf = segment_rows_plain(idx, upd, B * (H + 1) * (W + 1))
        buf = buf.reshape(B, H + 1, W + 1, 4, C)
        acc = buf.new_zeros((B, H + 2, W + 2, C))
        acc[:, :-1, :-1] += buf[..., 0, :]
        acc[:, :-1, 1:] += buf[..., 1, :]
        acc[:, 1:, :-1] += buf[..., 2, :]
        acc[:, 1:, 1:] += buf[..., 3, :]
        rows = acc[:, 1:-1].clone()
        rows[:, 0] += acc[:, 0]
        rows[:, -1] += acc[:, -1]
        dimg = rows[:, :, 1:-1].clone()
        dimg[:, :, 0] += rows[:, :, 0]
        dimg[:, :, -1] += rows[:, :, -1]
        dimg = dimg.to(img_dtype)
    if need_grid:
        dot = (win.to(dt) * gf[:, None, :]).sum(-1)  # (N, 4)
        if mask4 is not None:
            dot = torch.where(mask4, dot, torch.zeros((), dtype=dt,
                                                      device=dot.device))
        af = a.reshape(N).to(dt)
        bf = b.reshape(N).to(dt)
        dix = ((1.0 - bf) * (dot[:, 1] - dot[:, 0])
               + bf * (dot[:, 3] - dot[:, 2])).reshape(a.shape).to(a.dtype)
        diy = ((1.0 - af) * (dot[:, 2] - dot[:, 0])
               + af * (dot[:, 3] - dot[:, 1])).reshape(b.shape).to(b.dtype)
    return dimg, dix, diy


@functools.lru_cache(maxsize=None)
def _plan(c: int, max_vec: int = 4) -> tuple[int, int]:
    """(channels per lane and step, lanes per sample) for C channels.
    C < 4 (3-channel images) takes the narrow kernel, a thread per sample
    with a 4-channel-wide accumulator: (0, 1). Otherwise V = 4, 2 or 1,
    the widest that divides C (and that every vector access is aligned
    to: `max_vec`); a sample of at most 4 vectors takes one thread, else
    the group is the largest power of two ≤ 32 that leaves at most a
    quarter of its lane slots idle (C = 32 → 8 lanes, 64 → 16, 96 and
    128 → 32)."""
    if c < 4:
        return 0, 1
    vec = next(v for v in (4, 2, 1) if v <= max_vec and c % v == 0)
    nvec = c // vec
    if nvec <= 4:
        return vec, 1
    lanes = max(n for n in (1, 2, 4, 8, 16, 32)
                if 3 * n * -(-nvec // n) <= 4 * nvec)
    return vec, lanes


def _f32(t: torch.Tensor, what: str) -> torch.Tensor:
    """`t` as contiguous float32 (bf16 widened); raises for other dtypes.
    The warp's backward runs on a host-bound path: no call here that a
    float32, contiguous `t` does not need."""
    if t.dtype is not torch.float32:
        if t.dtype is not torch.bfloat16:
            raise TypeError(f"warp bwd kernel: unsupported {what} dtype "
                            f"{t.dtype}")
        t = t.float()
    return t if t.is_contiguous() else t.contiguous()


_IMAGE_DTYPES = (torch.float32, torch.bfloat16)


def warp_bwd_cuda(g, win, idx, w4, mask4, a, b, img_shape, img_dtype,
                  need_img: bool = True, need_grid: bool = True):
    """Launch the kernel (CUDA tensors): one zero fill of the float32 image
    gradient, the kernel, and a cast to `img_dtype` unless that is
    float32 (C < 4: the copy of C of the accumulator's 4 channels, cast on
    the way). Same arguments and results as `warp_bwd_plain`."""
    B, H, W, C = img_shape
    N = w4.shape[0]
    dev = win.device
    if win.dtype not in _IMAGE_DTYPES or img_dtype not in _IMAGE_DTYPES:
        raise TypeError(f"warp bwd kernel: unsupported image dtype "
                        f"{win.dtype} / {img_dtype}")
    if (win.shape != (N, 4, C) or idx.shape != (N,)
            or idx.dtype is not torch.int64 or w4.shape != (N, 4)
            or g.numel() != N * C or a.numel() != N or b.numel() != N
            or (mask4 is not None and (mask4.shape != (N, 4)
                                       or mask4.dtype is not torch.bool))
            or any(t.device != dev for t in (g, idx, w4, a, b))
            or (mask4 is not None and mask4.device != dev)):
        raise ValueError("warp bwd kernel: needs g (N·C), win (N, 4, C), "
                         "int64 idx (N,), w4 (N, 4), bool mask4 (N, 4) or "
                         "None and a, b (N) on one device")
    gf = _f32(g, "cotangent")
    w4f, af, bf = (_f32(t, "coordinate") for t in (w4, a, b))
    win, idx = win.contiguous(), idx.contiguous()
    mask4 = None if mask4 is None else mask4.contiguous()
    # the widest vector that every vector access is aligned to (the
    # outputs are fresh allocations)
    esz = win.element_size()
    gp, wp = gf.data_ptr(), win.data_ptr()
    max_vec = next(v for v in (4, 2, 1)
                   if gp % (4 * v) == 0 and wp % (esz * v) == 0)
    vec, lanes = _plan(C, max_vec)
    dimg = (torch.zeros((B, H, W, C if vec else 4), dtype=torch.float32,
                        device=dev) if need_img else None)
    dix = torch.empty_like(af) if need_grid else None
    diy = torch.empty_like(af) if need_grid else None
    lib = _build.library("segsum", _SIGNATURES)
    err = lib.pcfa_warp_bwd(
        gp, wp, esz == 2, idx.data_ptr(), w4f.data_ptr(),
        None if mask4 is None else mask4.data_ptr(), af.data_ptr(),
        bf.data_ptr(), None if dimg is None else dimg.data_ptr(),
        None if dix is None else dix.data_ptr(),
        None if diy is None else diy.data_ptr(), N, C, B, H, W, vec,
        lanes.bit_length() - 1, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "pcfa_warp_bwd")
    warp_bwd_cuda.launches += 1
    if need_img and not vec:
        dimg = torch.empty((B, H, W, C), dtype=img_dtype,
                           device=dev).copy_(dimg[..., :C])
    elif need_img and img_dtype is not torch.float32:
        dimg = dimg.to(img_dtype)
    if need_grid and a.dtype is not torch.float32:
        dix, diy = dix.to(a.dtype), diy.to(b.dtype)
    return dimg, dix, diy


warp_bwd_cuda.launches = 0


def warp_bwd(g, win, idx, w4, mask4, a, b, img_shape, img_dtype,
             need_img: bool = True, need_grid: bool = True):
    """The sampler's backward: (d img, d ix, d iy). CPU tensors: the plain
    version; CUDA tensors: the kernel. The span `op.warp.bwd`; each call
    counted as `warp.bwd` (`utils/profiling.py`), on the card one kernel
    launch."""
    dev = win.device
    args = (g, win, idx, w4, mask4, a, b, img_shape, img_dtype, need_img,
            need_grid)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"warp bwd: unsupported device {dev}")
    profiling.count("warp.bwd")
    with profiling.span("op.warp.bwd"):
        if dev.type == "cpu":
            return warp_bwd_plain(*args)
        return warp_bwd_cuda(*args)
