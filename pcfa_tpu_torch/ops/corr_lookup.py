"""Correlation-window lookup on the materialized pyramid: CUDA kernel,
autograd wrapper, launch counters and plain version.

Replaces the Pallas kernels of `pcfa_tpu/ops/pallas/corr_lookup.py`
(`_vslice_fwd_impl` forward, `_vslice_bwd` backward), which blend the
window's rows in a kernel and leave the columns to an XLA einsum. The CUDA
kernel (`csrc/corr_lookup.cu`) does the whole 2-D window: each query reads
one (2r+2)² patch per level and blends it; the backward gathers each patch
cell's ≤ 4 window cotangents into the query's own zeroed gradient map.

Bound on the H100 at RAFT's KITTI shape (B = 2, bf16, N = 14,664 queries,
4 levels): the forward moves ~21 MB (patch reads + 9.5 MB of output); the
backward's cost is the zero-filled gradient maps of all four levels,
141.5 M elements = 283 MB written per lookup. Both are memory-bound; see
the source's header for the design.

Contract (as the Pallas wrapper's): the gradient with respect to coords is
zero; RAFT detaches coords at every iteration anyway.

CPU tensors go to the plain version (`corr_window_plain`, built on
`bilinear_sampler`); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from pcfa_tpu_torch.ops import _build
from pcfa_tpu_torch.ops.warp import bilinear_sampler

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "pcfa_corr_window_fwd": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _P],
    "pcfa_corr_window_bwd": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _P],
}


def corr_window_plain(levels: list[torch.Tensor], coords: torch.Tensor,
                      radius: int = 4) -> torch.Tensor:
    """Plain version. levels: (N, H2ₗ, W2ₗ); coords: (N, 2) level-0
    pixels, (x, y). Returns (N, L·(2r+1)²) in the maps' dtype; per level,
    index a·(2r+1)+b samples at (x + a − r, y + b − r) — the FIRST offset
    moves x, the reference's transposed-window quirk. Computed in float32,
    or float64 for float64 maps."""
    r = radius
    P = 2 * r + 1
    N = coords.shape[0]
    dt = torch.promote_types(levels[0].dtype, torch.float32)
    lin = torch.linspace(-r, r, P, device=coords.device, dtype=dt)
    da, db = torch.meshgrid(lin, lin, indexing="ij")
    delta = torch.stack([da, db], dim=-1)  # [..., 0] is added to x
    out = []
    for i, cmap in enumerate(levels):
        centroid = coords.to(dt).reshape(N, 1, 1, 2) / 2**i
        sampled = bilinear_sampler(cmap[..., None], centroid + delta[None])
        out.append(sampled.reshape(N, P * P))
    return torch.cat(out, dim=-1)


def corr_window_bwd_plain(grad_out: torch.Tensor, levels: list[torch.Tensor],
                          coords: torch.Tensor, radius: int = 4
                          ) -> list[torch.Tensor]:
    """Plain version of the backward: the maps' gradient by autograd through
    `corr_window_plain` (float32), in the maps' dtype."""
    with torch.enable_grad():
        lv = [t.detach().to(torch.float32).requires_grad_(True)
              for t in levels]
        out = corr_window_plain(lv, coords.detach(), radius)
        grads = torch.autograd.grad(out, lv, grad_out.to(torch.float32))
    return [g.to(t.dtype) for g, t in zip(grads, levels)]


def _level_args(levels):
    L = len(levels)
    heights = (ctypes.c_int * L)(*[int(t.shape[1]) for t in levels])
    widths = (ctypes.c_int * L)(*[int(t.shape[2]) for t in levels])
    return heights, widths


def _check_levels(levels, coords):
    dt = levels[0].dtype
    if dt not in _DTYPES:
        raise TypeError(f"corr lookup kernel: unsupported dtype {dt}")
    N = coords.shape[0]
    for t in levels:
        if (t.dtype != dt or t.device != coords.device or t.dim() != 3
                or t.shape[0] != N or not t.is_contiguous()):
            raise ValueError(
                "corr lookup kernel: levels must be contiguous (N, H, W) "
                "tensors of one dtype on the coords' device")
    if coords.dtype != torch.float32 or coords.shape != (N, 2) \
            or not coords.is_contiguous():
        raise ValueError("corr lookup kernel: coords must be contiguous "
                         "float32 (N, 2)")


def corr_window_fwd(levels: list[torch.Tensor], coords: torch.Tensor,
                    radius: int = 4) -> torch.Tensor:
    """Launch the forward kernel (CUDA tensors only)."""
    _check_levels(levels, coords)
    lib = _build.library("corr_lookup", _SIGNATURES)
    L, N, P = len(levels), coords.shape[0], 2 * radius + 1
    out = torch.empty((N, L * P * P), dtype=levels[0].dtype,
                      device=coords.device)
    maps = (ctypes.c_void_p * L)(*[t.data_ptr() for t in levels])
    heights, widths = _level_args(levels)
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    err = lib.pcfa_corr_window_fwd(
        _DTYPES[levels[0].dtype], L, maps, heights, widths,
        coords.data_ptr(), out.data_ptr(), N, radius, stream)
    _build.check(err, "pcfa_corr_window_fwd")
    corr_window_fwd.launches += 1
    return out


corr_window_fwd.launches = 0


def corr_window_bwd(grad_out: torch.Tensor, levels: list[torch.Tensor],
                    coords: torch.Tensor, radius: int = 4
                    ) -> list[torch.Tensor]:
    """Launch the backward kernel: the gradient maps of every level
    (zero-filled here; the kernel writes only each window's cells)."""
    _check_levels(levels, coords)
    lib = _build.library("corr_lookup", _SIGNATURES)
    L, N, P = len(levels), coords.shape[0], 2 * radius + 1
    grad_out = grad_out.to(levels[0].dtype).contiguous()
    if grad_out.shape != (N, L * P * P):
        raise ValueError(f"corr lookup kernel: cotangent shape "
                         f"{tuple(grad_out.shape)} != {(N, L * P * P)}")
    dmaps = [torch.zeros_like(t) for t in levels]
    ptrs = (ctypes.c_void_p * L)(*[t.data_ptr() for t in dmaps])
    heights, widths = _level_args(levels)
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    err = lib.pcfa_corr_window_bwd(
        _DTYPES[levels[0].dtype], L, ptrs, heights, widths,
        coords.data_ptr(), grad_out.data_ptr(), N, radius, stream)
    _build.check(err, "pcfa_corr_window_bwd")
    corr_window_bwd.launches += 1
    return dmaps


corr_window_bwd.launches = 0


class _CorrWindow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coords, radius, *levels):
        ctx.radius = radius
        ctx.save_for_backward(coords, *levels)
        return corr_window_fwd(list(levels), coords, radius)

    @staticmethod
    def backward(ctx, grad_out):
        coords, *levels = ctx.saved_tensors
        if not any(ctx.needs_input_grad[2:]):
            return (None, None) + (None,) * len(levels)
        dmaps = corr_window_bwd(grad_out, levels, coords, ctx.radius)
        return (None, None, *dmaps)


def corr_window(levels: list[torch.Tensor], coords: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """Window lookup, (N, L·(2r+1)²). CPU tensors: the plain version; CUDA
    tensors: the kernel (differentiable in the maps, zero in coords)."""
    coords = coords.detach()
    dev = levels[0].device
    if dev.type == "cpu":
        return corr_window_plain(levels, coords, radius)
    if dev.type != "cuda":
        raise ValueError(f"corr lookup: unsupported device {dev}")
    coords = coords.to(torch.float32).contiguous()
    return _CorrWindow.apply(coords, radius,
                             *[t.contiguous() for t in levels])
