"""Small-channel SAME convolution: CUDA kernel (forward and dx), autograd
wrapper, launch counters and plain version.

Replaces the Pallas kernel of `pcfa_tpu/ops/pallas/small_conv.py`
(`_forward`, the shifted-slab block-Toeplitz conv, and the custom VJP
`_bwd`, whose dx reruns `_forward` with flipped, channel-transposed weights
on a zero-dilated cotangent). In RAFT it runs the encoders' 7×7/2 RGB stem
and the four 3×3 layer1 convs of each encoder.

Bound on the H100 at RAFT's KITTI shape (B = 2 pairs, bf16): the fnet stem
(4 images, 3→64) moves ~71 MB for 8.8 GFLOP (≈21 µs at 3.35 TB/s); one
fnet layer1 conv (64→64 at 188×624) moves ~120 MB for 34.6 GFLOP (≈36 µs).
The kernel (`csrc/small_conv.cu`) is a direct conv on the CUDA cores with
float32 FMA, weights staged in shared memory: right first, so its own
ceiling is the FLOPs; tensor cores, TMA and tiling are later work.

Semantics: torch `Conv2d(k, stride=s, padding=k//2)` on NCHW with fused
bias and none/'relu'/'leaky' (0.1), every H and W (stride 2 gives
ceil(H/2), as torch does), float32 or bfloat16 with float32 accumulation.

CPU tensors go to the plain version (`conv_plain`: `F.conv2d` + act);
CUDA tensors launch the kernel or raise. dw/db (never needed by the attack:
the networks are frozen) are plain torch ops, computed only on request.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pcfa_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {None: 0, "relu": 1, "leaky": 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "pcfa_small_conv_fwd": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P],
    "pcfa_small_conv_dx": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}


def _apply_act(out: torch.Tensor, act: str | None) -> torch.Tensor:
    if act == "relu":
        return torch.relu(out)
    if act == "leaky":
        return F.leaky_relu(out, 0.1)
    if act is None:
        return out
    raise ValueError(f"small conv: unsupported act {act!r}")


def conv_plain(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None = None, stride: int = 1,
               act: str | None = None) -> torch.Tensor:
    """Plain version: `F.conv2d(padding=k//2)` + activation."""
    k = weight.shape[-1]
    return _apply_act(F.conv2d(x, weight, bias, stride, k // 2), act)


def conv_dx_plain(g: torch.Tensor, weight: torch.Tensor, x_shape,
                  stride: int = 1) -> torch.Tensor:
    """Plain input gradient of the conv (activation already applied to g)."""
    k = weight.shape[-1]
    return torch.nn.grad.conv2d_input(tuple(x_shape), weight, g, stride,
                                      k // 2)


def _out_size(n: int, k: int, s: int) -> int:
    return (n + 2 * (k // 2) - k) // s + 1


def _check(x, weight, bias, stride):
    if x.dtype not in _DTYPES:
        raise TypeError(f"small conv kernel: unsupported dtype {x.dtype}")
    k = weight.shape[-1]
    if (weight.dim() != 4 or weight.shape[-2] != k or k not in (3, 5, 7)
            or stride not in (1, 2) or x.dim() != 4
            or weight.shape[1] != x.shape[1]):
        raise ValueError(
            f"small conv kernel: needs NCHW x, OIHW k×k weights with k in "
            f"(3, 5, 7) and stride 1 or 2; got x {tuple(x.shape)}, weight "
            f"{tuple(weight.shape)}, stride {stride}")
    for t in (weight, bias):
        if t is not None and (t.dtype != x.dtype or t.device != x.device):
            raise ValueError("small conv kernel: x, weight and bias must "
                             "share dtype and device")


def small_conv_fwd(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None = None, stride: int = 1,
                   act: str | None = None) -> torch.Tensor:
    """Launch the forward kernel (CUDA tensors only)."""
    _check(x, weight, bias, stride)
    lib = _build.library("small_conv", _SIGNATURES)
    x = x.contiguous()
    weight = weight.contiguous()
    bias = bias.contiguous() if bias is not None else None
    B, C_in, H, W = x.shape
    C_out, k = weight.shape[0], weight.shape[-1]
    out = torch.empty((B, C_out, _out_size(H, k, stride),
                       _out_size(W, k, stride)), dtype=x.dtype,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.pcfa_small_conv_fwd(
        _DTYPES[x.dtype], x.data_ptr(), weight.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        B, C_in, H, W, C_out, k, stride, _ACTS[act], stream)
    _build.check(err, "pcfa_small_conv_fwd")
    small_conv_fwd.launches += 1
    return out


small_conv_fwd.launches = 0


def small_conv_dx(g: torch.Tensor, weight: torch.Tensor, x_shape,
                  stride: int = 1) -> torch.Tensor:
    """Launch the dx kernel: the transposed conv in gather form."""
    B, C_in, H, W = (int(v) for v in x_shape)
    C_out, k = weight.shape[0], weight.shape[-1]
    dx = torch.empty((B, C_in, H, W), dtype=g.dtype, device=g.device)
    _check(dx, weight, None, stride)
    if g.shape != (B, C_out, _out_size(H, k, stride),
                   _out_size(W, k, stride)):
        raise ValueError(f"small conv kernel: cotangent shape "
                         f"{tuple(g.shape)} does not match the conv")
    lib = _build.library("small_conv", _SIGNATURES)
    g = g.contiguous()
    weight = weight.contiguous()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.pcfa_small_conv_dx(
        _DTYPES[g.dtype], g.data_ptr(), weight.data_ptr(), dx.data_ptr(),
        B, C_in, H, W, C_out, k, stride, stream)
    _build.check(err, "pcfa_small_conv_dx")
    small_conv_dx.launches += 1
    return dx


small_conv_dx.launches = 0


class _SmallConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, stride, act):
        out = small_conv_fwd(x, weight, bias, stride, act)
        ctx.stride, ctx.act = stride, act
        ctx.x_shape = tuple(x.shape)
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None,
                              weight, out if act is not None else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, weight, out = ctx.saved_tensors
        if ctx.act == "relu":
            g = g * (out > 0)
        elif ctx.act == "leaky":
            g = g * torch.where(out > 0, 1.0, 0.1).to(g.dtype)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = small_conv_dx(g, weight, ctx.x_shape, ctx.stride)
        if ctx.needs_input_grad[1]:
            k = weight.shape[-1]
            dw = torch.nn.grad.conv2d_weight(x, weight.shape, g, ctx.stride,
                                             k // 2)
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 2, 3))
        return dx, dw, db, None, None


def small_conv2d(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None = None, stride: int = 1,
                 act: str | None = None) -> torch.Tensor:
    """SAME conv, NCHW. CPU tensors: the plain version; CUDA tensors: the
    kernel, differentiable (dx by the dx kernel)."""
    if x.device.type == "cpu":
        return conv_plain(x, weight, bias, stride, act)
    if x.device.type != "cuda":
        raise ValueError(f"small conv: unsupported device {x.device}")
    return _SmallConv.apply(x, weight, bias, stride, act)
