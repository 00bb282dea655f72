"""Patch correlation of two channels-last feature maps: CUDA kernels
(forward and backward), autograd wrapper, launch counters and plain
versions.

Replaces the Pallas kernels of `pcfa_tpu/ops/pallas/local_corr.py`:
`_forward` (behind `local_correlation_pallas` and
`global_correlation_pallas`) and `_backward` (`_dgrad1_kernel`,
`_dgrad2_kernel`). PWCNet runs patch 9, stride 1 (81 channels) at five
pyramid levels per forward; FlowNetC's global correlation is patch 21,
stride 2 (441 channels) on the same kernel.

Semantics, with R = (patch−1)/2·stride and shift p = iy·patch + ix
(iy moves rows, ix columns; dy = iy·stride − R, dx = ix·stride − R):
    out[b, y, x, p] = Σ_c f1[b, y, x, c] · f2[b, y+dy, x+dx, c] / C
with zero padding and division by the real C. (B, H, W, C) in, (B, H, W,
patch²) out, in the input dtype, accumulated in float32. The kernels take
every map size (the Pallas backward hands maps under 1024 pixels to XLA;
nothing here depends on size) and float32 or bfloat16.

Bound on the H100 (PWCNet at 384×1280, B = 1, bf16): every level is
memory-bound; the largest (96×320, C = 32) moves ~9 MB per forward. See
`csrc/local_corr.cu` for the design.

CPU tensors go to the plain versions; CUDA tensors launch the kernels or
raise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pcfa_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "pcfa_local_corr_fwd": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "pcfa_local_corr_bwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _P],
}
MAX_PATCH = 21
MAX_RADIUS = 20


def local_corr_plain(fmap1: torch.Tensor, fmap2: torch.Tensor,
                     patch: int = 9, stride: int = 1) -> torch.Tensor:
    """Plain version: one shifted product per displacement, summed over
    channels in float32 (float64 for float64 maps), in the maps' dtype."""
    B, H, W, C = fmap1.shape
    R = (patch - 1) // 2 * stride
    dt = torch.promote_types(fmap1.dtype, torch.float32)
    f1 = fmap1.to(dt)
    f2p = F.pad(fmap2.to(dt), (0, 0, R, R, R, R))
    out = [(f1 * f2p[:, iy * stride:iy * stride + H,
                     ix * stride:ix * stride + W]).sum(-1)
           for iy in range(patch) for ix in range(patch)]
    return (torch.stack(out, dim=-1) / C).to(fmap1.dtype)


def local_corr_bwd_plain(g: torch.Tensor, fmap1: torch.Tensor,
                         fmap2: torch.Tensor, patch: int = 9,
                         stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain backward: (df1, df2) by autograd through `local_corr_plain`
    (float32, or float64 for float64 maps), in the maps' dtype."""
    dt = torch.promote_types(fmap1.dtype, torch.float32)
    with torch.enable_grad():
        a = fmap1.detach().to(dt).requires_grad_(True)
        b = fmap2.detach().to(dt).requires_grad_(True)
        out = local_corr_plain(a, b, patch, stride)
        da, db = torch.autograd.grad(out, (a, b), g.to(dt))
    return da.to(fmap1.dtype), db.to(fmap2.dtype)


def _check(fmap1, fmap2, patch, stride):
    if fmap1.dtype not in _DTYPES:
        raise TypeError(f"local corr kernel: unsupported dtype {fmap1.dtype}")
    if (fmap1.dim() != 4 or fmap2.shape != fmap1.shape
            or fmap2.dtype != fmap1.dtype or fmap2.device != fmap1.device
            or not fmap1.is_contiguous() or not fmap2.is_contiguous()):
        raise ValueError("local corr kernel: f1 and f2 must be contiguous "
                         "(B, H, W, C) tensors of one shape, dtype and device")
    if (patch < 1 or patch % 2 == 0 or patch > MAX_PATCH or stride < 1
            or (patch - 1) // 2 * stride > MAX_RADIUS):
        raise ValueError(f"local corr kernel: needs an odd patch ≤ "
                         f"{MAX_PATCH} and (patch−1)/2·stride ≤ {MAX_RADIUS}; "
                         f"got patch {patch}, stride {stride}")


def local_corr_fwd(fmap1: torch.Tensor, fmap2: torch.Tensor, patch: int = 9,
                   stride: int = 1) -> torch.Tensor:
    """Launch the forward kernel (CUDA tensors only)."""
    _check(fmap1, fmap2, patch, stride)
    lib = _build.library("local_corr", _SIGNATURES)
    B, H, W, C = fmap1.shape
    out = torch.empty((B, H, W, patch * patch), dtype=fmap1.dtype,
                      device=fmap1.device)
    stream = torch.cuda.current_stream(fmap1.device).cuda_stream
    err = lib.pcfa_local_corr_fwd(
        _DTYPES[fmap1.dtype], fmap1.data_ptr(), fmap2.data_ptr(),
        out.data_ptr(), B, H, W, C, patch, stride, stream)
    _build.check(err, "pcfa_local_corr_fwd")
    local_corr_fwd.launches += 1
    return out


local_corr_fwd.launches = 0


def local_corr_bwd(g: torch.Tensor, fmap1: torch.Tensor, fmap2: torch.Tensor,
                   patch: int = 9, stride: int = 1
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: (df1, df2) in one launch."""
    _check(fmap1, fmap2, patch, stride)
    B, H, W, C = fmap1.shape
    g = g.to(fmap1.dtype).contiguous()
    if g.shape != (B, H, W, patch * patch) or g.device != fmap1.device:
        raise ValueError(f"local corr kernel: cotangent {tuple(g.shape)} "
                         f"on {g.device} != {(B, H, W, patch * patch)} on "
                         f"{fmap1.device}")
    lib = _build.library("local_corr", _SIGNATURES)
    df1 = torch.empty_like(fmap1)
    df2 = torch.empty_like(fmap2)
    stream = torch.cuda.current_stream(fmap1.device).cuda_stream
    err = lib.pcfa_local_corr_bwd(
        _DTYPES[fmap1.dtype], fmap1.data_ptr(), fmap2.data_ptr(),
        g.data_ptr(), df1.data_ptr(), df2.data_ptr(), B, H, W, C, patch,
        stride, stream)
    _build.check(err, "pcfa_local_corr_bwd")
    local_corr_bwd.launches += 1
    return df1, df2


local_corr_bwd.launches = 0


class _LocalCorr(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fmap1, fmap2, patch, stride):
        ctx.patch, ctx.stride = patch, stride
        ctx.save_for_backward(fmap1, fmap2)
        return local_corr_fwd(fmap1, fmap2, patch, stride)

    @staticmethod
    def backward(ctx, g):
        fmap1, fmap2 = ctx.saved_tensors
        if not any(ctx.needs_input_grad[:2]):
            return None, None, None, None
        df1, df2 = local_corr_bwd(g, fmap1, fmap2, ctx.patch, ctx.stride)
        return (df1 if ctx.needs_input_grad[0] else None,
                df2 if ctx.needs_input_grad[1] else None, None, None)


def local_corr(fmap1: torch.Tensor, fmap2: torch.Tensor, patch: int = 9,
               stride: int = 1) -> torch.Tensor:
    """Patch correlation, (B, H, W, patch²). CPU tensors: the plain
    version; CUDA tensors: the kernels (differentiable in both maps)."""
    dev = fmap1.device
    if dev.type == "cpu":
        return local_corr_plain(fmap1, fmap2, patch, stride)
    if dev.type != "cuda":
        raise ValueError(f"local corr: unsupported device {dev}")
    return _LocalCorr.apply(fmap1.contiguous(), fmap2.contiguous(), patch,
                            stride)
