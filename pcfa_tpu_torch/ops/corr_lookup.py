"""Correlation-window lookup on the materialized pyramid: CUDA kernels,
autograd wiring, launch counters and plain versions.

Replaces the Pallas kernels of `pcfa_tpu/ops/pallas/corr_lookup.py`
(`_vslice_fwd_impl` forward, `_vslice_bwd` backward), which blend the
window's rows in a kernel and leave the columns to an XLA einsum. The CUDA
kernels (`csrc/corr_lookup.cu`) do the whole 2-D window: each query reads
one (2r+2)² patch per level and blends it; the backward adds each patch
cell's ≤ 4 window cotangents into gradient buffers the caller owns.

Bound on the H100 at RAFT's KITTI shape (B = 2, bf16, N = 14,664 queries,
4 levels): the forward moves ~21 MB (patch reads + 9.5 MB of output), the
backward reads the 9.5 MB cotangent and read-modify-writes ≤ 11.7 MB of
patch cells; see the source's header for the design and what holds each
kernel above that.

Gradient accumulation. RAFT looks one pyramid up 12 times per forward.
`pyramid_with_grad` passes the levels through `_PyramidGrad`, an identity
node that owns one gradient buffer per level for each backward pass; each
lookup's backward (`_CorrWindow`) adds into those buffers, zero-filled at
the first lookup backward of a pass, and returns no gradient for the
levels. Autograd runs `_PyramidGrad`'s backward after every lookup that
reached the loss, and it hands the buffers on (plus any gradient from
another use of the levels) and drops them. So a backward pass fills the
pyramid's gradient once and sums nothing. A lookup on levels without such
a node (a plain list of tensors) fills its own zeroed buffers and returns
them. The gradient with respect to the pyramid's node outputs themselves
(`torch.autograd.grad(loss, pyramid)`) is not available: take it with
respect to what the pyramid was computed from.

Contract (as the Pallas wrapper's): the gradient with respect to coords is
zero; RAFT detaches coords at every iteration anyway.

CPU tensors go through the same two Functions with the plain versions
(`corr_window_plain`, `corr_window_bwd_plain` plus an add); CUDA tensors
launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from pcfa_tpu_torch.ops import _build
from pcfa_tpu_torch.ops.warp import bilinear_sampler

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_RADIUS = 7
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
    """Plain version of one lookup's backward: the maps' gradient by
    autograd through `corr_window_plain`, computed as it computes (float32,
    or float64 for float64 maps), in the maps' dtype. Only the levels'
    shapes and dtype matter."""
    dt = torch.promote_types(levels[0].dtype, torch.float32)
    with torch.enable_grad():
        lv = [t.detach().to(dt).requires_grad_(True) for t in levels]
        out = corr_window_plain(lv, coords.detach(), radius)
        grads = torch.autograd.grad(out, lv, grad_out.to(dt))
    return [g.to(t.dtype) for g, t in zip(grads, levels)]


def corr_window_bwd_acc_plain(grad_out: torch.Tensor,
                              dmaps: list[torch.Tensor], coords: torch.Tensor,
                              radius: int = 4) -> list[torch.Tensor]:
    """Plain version of the accumulating backward: adds one lookup's
    gradient, rounded to the maps' dtype, into `dmaps` in place (as the
    kernel does, and as autograd's sum of per-lookup gradients did)."""
    for d, g in zip(dmaps, corr_window_bwd_plain(grad_out, dmaps, coords,
                                                 radius)):
        d.add_(g)
    return dmaps


def _level_args(levels):
    L = len(levels)
    heights = (ctypes.c_int * L)(*[int(t.shape[1]) for t in levels])
    widths = (ctypes.c_int * L)(*[int(t.shape[2]) for t in levels])
    return heights, widths


def _check_levels(levels, coords, radius):
    dt = levels[0].dtype
    if dt not in _DTYPES:
        raise TypeError(f"corr lookup kernel: unsupported dtype {dt}")
    if not 0 <= radius <= _MAX_RADIUS:
        raise ValueError(f"corr lookup kernel: radius {radius} not in "
                         f"[0, {_MAX_RADIUS}]")
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
    _check_levels(levels, coords, radius)
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


def corr_window_bwd(grad_out: torch.Tensor, dmaps: list[torch.Tensor],
                    coords: torch.Tensor, radius: int = 4
                    ) -> list[torch.Tensor]:
    """Launch the accumulating backward kernel (CUDA tensors only): adds
    the window's gradient into `dmaps`, one buffer per level shaped like
    the maps, in place; returns `dmaps`. The kernel touches only each
    query's in-map patch cells."""
    _check_levels(dmaps, coords, radius)
    lib = _build.library("corr_lookup", _SIGNATURES)
    L, N, P = len(dmaps), coords.shape[0], 2 * radius + 1
    grad_out = grad_out.to(dmaps[0].dtype).contiguous()
    if grad_out.shape != (N, L * P * P):
        raise ValueError(f"corr lookup kernel: cotangent shape "
                         f"{tuple(grad_out.shape)} != {(N, L * P * P)}")
    ptrs = (ctypes.c_void_p * L)(*[t.data_ptr() for t in dmaps])
    heights, widths = _level_args(dmaps)
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    err = lib.pcfa_corr_window_bwd(
        _DTYPES[dmaps[0].dtype], L, ptrs, heights, widths,
        coords.data_ptr(), grad_out.data_ptr(), N, radius, stream)
    _build.check(err, "pcfa_corr_window_bwd")
    corr_window_bwd.launches += 1
    return dmaps


corr_window_bwd.launches = 0


def _zeros(like) -> list[torch.Tensor]:
    """Zeroed buffers for `like`: (shape, dtype, device) per level."""
    return [torch.zeros(s, dtype=dt, device=dev) for s, dt, dev in like]


class _GradBuffers:
    """The gradient buffers of one pyramid for the backward pass under
    way: zero-filled at the first lookup backward, handed on and dropped
    by `_PyramidGrad`'s backward."""

    __slots__ = ("bufs",)

    def __init__(self):
        self.bufs = None

    def take(self, like) -> list[torch.Tensor]:
        if self.bufs is None:
            self.bufs = _zeros(like)
        return self.bufs


class _PyramidGrad(torch.autograd.Function):
    """Identity on the pyramid's levels that owns their gradient buffers."""

    @staticmethod
    def forward(ctx, acc, *levels):
        ctx.set_materialize_grads(False)
        ctx.acc = acc
        return tuple(t.view_as(t) for t in levels)

    @staticmethod
    def backward(ctx, *grads):
        bufs, ctx.acc.bufs = ctx.acc.bufs, None
        if bufs is None:
            return (None, *grads)
        for b, g in zip(bufs, grads):
            if g is not None:
                b.add_(g)
        return (None, *bufs)


class Pyramid(list):
    """The pyramid's levels (a list of tensors) with the gradient buffers
    their lookups add into (`acc`, None where the levels need no
    gradient)."""

    acc: _GradBuffers | None = None


def pyramid_with_grad(levels: list[torch.Tensor]) -> Pyramid:
    """`levels` as a `Pyramid` whose lookups accumulate one gradient per
    level (through `_PyramidGrad`) when autograd records them."""
    if not (torch.is_grad_enabled() and any(t.requires_grad
                                            for t in levels)):
        return Pyramid(levels)
    acc = _GradBuffers()
    pyr = Pyramid(_PyramidGrad.apply(acc, *levels))
    pyr.acc = acc
    return pyr


class _CorrWindow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coords, radius, acc, *levels):
        ctx.radius, ctx.acc = radius, acc
        ctx.like = [(t.shape, t.dtype, t.device) for t in levels]
        ctx.save_for_backward(coords)
        if coords.device.type == "cuda":
            return corr_window_fwd(list(levels), coords, radius)
        return corr_window_plain(list(levels), coords, radius)

    @staticmethod
    def backward(ctx, grad_out):
        (coords,) = ctx.saved_tensors
        none = (None,) * (3 + len(ctx.like))
        if not any(ctx.needs_input_grad[3:]):
            return none
        dmaps = (ctx.acc.take(ctx.like) if ctx.acc is not None
                 else _zeros(ctx.like))
        if coords.device.type == "cuda":
            corr_window_bwd(grad_out, dmaps, coords, ctx.radius)
        else:
            corr_window_bwd_acc_plain(grad_out, dmaps, coords, ctx.radius)
        return none if ctx.acc is not None else (None, None, None, *dmaps)


def corr_window(levels: list[torch.Tensor], coords: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """Window lookup, (N, L·(2r+1)²), differentiable in the maps, zero in
    coords. CPU tensors: the plain versions; CUDA tensors: the kernels.
    Lookups on a `Pyramid` from `pyramid_with_grad` add their gradient
    into its buffers."""
    coords = coords.detach()
    dev = levels[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"corr lookup: unsupported device {dev}")
    if dev.type == "cuda":
        coords = coords.to(torch.float32).contiguous()
    return _CorrWindow.apply(coords, radius, getattr(levels, "acc", None),
                             *[t.contiguous() for t in levels])
