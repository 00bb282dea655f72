"""Small-channel SAME convolution: CUDA kernels (forward and dx), their
plan and weight packing, autograd wrapper, launch counters and plain
versions.

Replaces the Pallas kernel of `pcfa_tpu/ops/pallas/small_conv.py`
(`_forward`, the shifted-slab block-Toeplitz conv, and the custom VJP
`_bwd`, whose dx reruns `_forward` with flipped, channel-transposed weights
on a zero-dilated cotangent). In RAFT it runs the encoders' 7×7/2 RGB stem
and the four 3×3 layer1 convs of each encoder; in PWCNet the eleven 3×3
pyramid and context convs with the leaky epilogue.

Bound on the H100: bytes, at every main-path shape (RAFT's fnet layer1,
4×64×188×624 in bf16, moves ~120 MB for 34.6 GFLOP: ≈36 µs at 3.35 TB/s;
the stem ~71 MB for 8.8 GFLOP; PWCNet's layers less work per byte still).

Design (`csrc/small_conv.cu` has the details). bfloat16 runs an implicit
GEMM on the tensor cores (`mma.sync` m16n8k16, k8 for C_in ≤ 8, float32
accumulators): M = output pixels of a tile, N = output channels, K = taps
× input channels. The input halo arrives by `cp.async` and is
transposed to channels-innermost in shared memory; the next chunk's
loads overlap the MMAs of the current one. `_plan` picks per shape the
tile (1–8 output rows of 16 or 32 pixels), whether N is split across
blocks, and whether the input-channel chunks are double-buffered, so that
every main-path shape launches ≥ 2 × 132 blocks within the shared
memory. `_gemm_classes` gives
the GEMMs of one launch: the forward is one; dx is the transposed conv in
gather form, one GEMM for stride 1 (flipped, channel-transposed weights)
and one per output parity class for stride 2, each a stride-1 correlation
of the cotangent with that class's taps. `_pack_weights` lays the weights
out once per weight tensor (cached) as bf16 [group][chunk][tap][c][n].
dx applies the activation's derivative (from the forward's saved output)
while it stages the cotangent. float32 runs direct kernels on the CUDA
cores (TF32 would not hold 1e-4 of the plain result); no timed main path
runs float32.

Semantics: torch `Conv2d(k, stride=s, padding=k//2)` on NCHW with fused
bias and none/'relu'/'leaky' (0.1), k in 3/5/7, stride 1 or 2, every B, H,
W, C_in and C_out (stride 2 gives ceil(H/2), as torch does).

CPU tensors go to the plain version (`conv_plain`: `F.conv2d` + act);
CUDA tensors launch the kernel or raise. dw/db (never needed by the attack:
the networks are frozen) are plain torch ops, computed only on request.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import torch
import torch.nn.functional as F

from pcfa_tpu_torch.ops import _build

_ACTS = {None: 0, "relu": 1, "leaky": 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "pcfa_small_conv_fwd_f32": [_P, _P, _P, _P] + [_I] * 8 + [_P],
    "pcfa_small_conv_dx_f32": [_P, _P, _P, _P] + [_I] * 8 + [_P],
    "pcfa_small_conv_tc": [_P] * 5 + [_I] * 23
    + [ctypes.POINTER(_I), _I, _I, _P],
}

# bf16 tiles, largest first: (output rows = warps, 16-pixel fragments)
_TILES = ((8, 2), (4, 2), (4, 1), (2, 1))
_NFS = (1, 2, 4, 8, 12)       # 8-channel N fragments a kernel can hold
_MIN_BLOCKS = 2 * 132         # two blocks per H100 SM
_SMEM_MAX = 232448            # shared memory a block may use


def _act_grad(g: torch.Tensor, out: torch.Tensor | None,
              act: str | None) -> torch.Tensor:
    """g times the activation's derivative at the forward output `out`."""
    if act is None:
        return g
    if out is None:
        raise ValueError(f"small conv: act {act!r} needs the forward output")
    if act == "relu":
        return g * (out > 0)
    if act == "leaky":
        return g * torch.where(out > 0, 1.0, 0.1).to(g.dtype)
    raise ValueError(f"small conv: unsupported act {act!r}")


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
                  stride: int = 1, out: torch.Tensor | None = None,
                  act: str | None = None) -> torch.Tensor:
    """Plain input gradient of `conv_plain(..., act)`: g is the cotangent
    of the activated output `out`."""
    k = weight.shape[-1]
    return torch.nn.grad.conv2d_input(tuple(x_shape), weight,
                                      _act_grad(g, out, act), stride, k // 2)


def _out_size(n: int, k: int, s: int) -> int:
    return (n + 2 * (k // 2) - k) // s + 1


# ------------------------------------------------------------ bf16 plan ---

class GemmClass(NamedTuple):
    """One GEMM of a launch: output pixels (u, v) < (hc, wc), stored at
    (u·OS + py, v·OS + px); tap (jy, jx) reads the GEMM input at
    (u·S + by + jy, v·S + bx + jx) with the weights of (kys[jy], kxs[jx])."""
    ty: int
    tx: int
    by: int
    bx: int
    hc: int
    wc: int
    py: int
    px: int
    kys: tuple
    kxs: tuple


def _parity_taps(k: int, par: int) -> tuple[tuple, int]:
    """Stride-2 dx along one axis, for outputs 2u + par: the kernel taps
    that reach them (in GEMM order) and the cotangent offset of the first."""
    p = k // 2
    k0 = (par + p) % 2
    n = (k - k0 + 1) // 2
    return (tuple(k0 + 2 * (n - 1 - j) for j in range(n)),
            (par + p - k0) // 2 - n + 1)


def _gemm_classes(kind: str, k: int, s: int, H: int, W: int) -> list:
    """The GEMMs of the forward ('fwd') or dx ('dx') of a conv whose input
    is H × W."""
    p = k // 2
    if kind == "fwd":
        taps = tuple(range(k))
        return [GemmClass(k, k, -p, -p, _out_size(H, k, s),
                          _out_size(W, k, s), 0, 0, taps, taps)]
    if s == 1:
        flip = tuple(range(k - 1, -1, -1))
        return [GemmClass(k, k, -p, -p, H, W, 0, 0, flip, flip)]
    out = []
    for py in (0, 1):
        for px in (0, 1):
            hc, wc = (H - py + 1) // 2, (W - px + 1) // 2
            if hc and wc:
                kys, by = _parity_taps(k, py)
                kxs, bx = _parity_taps(k, px)
                out.append(GemmClass(len(kys), len(kxs), by, bx, hc, wc,
                                     py, px, kys, kxs))
    return out


class Plan(NamedTuple):
    kind: str
    C: int          # GEMM input channels (K per tap)
    N: int          # GEMM output channels
    S: int          # stride on the GEMM input
    OS: int         # stride of the stores
    kc: int
    th: int
    mf: int
    nf: int
    groups: int
    nbuf: int
    raw_bytes: int
    a_bytes: int
    w_bytes: int
    smem: int
    tiles_x: int
    tiles_y: int
    blocks: int
    classes: tuple
    woffs: tuple


def _round(n: int, to: int = 128) -> int:
    return -(-n // to) * to


def _plan(kind: str, x_shape, c_out: int, k: int, s: int,
          masked: bool = False) -> Plan:
    """Tile, N split and buffering of the bf16 kernel for one conv (dx
    `masked`: the forward output is staged beside the cotangent)."""
    B, c_in, H, W = x_shape
    classes = tuple(_gemm_classes(kind, k, s, H, W))
    C, N, S, OS = ((c_in, c_out, s, 1) if kind == "fwd"
                   else (c_out, c_in, 1, s))
    kc = 8 if C <= 8 else 16
    nchunk = -(-C // kc)
    ty = max(c.ty for c in classes)
    tx = max(c.tx for c in classes)
    taps = max(c.ty * c.tx for c in classes)
    nf = next((f for f in _NFS if 8 * f >= N), 8)
    splits = [nf] + ([4] if nf >= 8 else [])
    fitting = []
    for nf in splits:
        groups = -(-N // (8 * nf))
        wp = (nf if nf % 2 else nf + 1) * 8
        for th, mf in _TILES:
            tw = 16 * mf
            ih, iw = (th - 1) * S + ty, (tw - 1) * S + tx
            iwp = 2 * (-(-iw // 2)) if S == 2 else iw
            # raw rows start at a multiple of 8 columns, up to 7 early
            raw_bytes = _round(kc * ih * ((iw + 14) // 8 * 8) * 2)
            a_bytes = _round(ih * iwp * kc * 2)
            w_bytes = _round(taps * kc * wp * 2)
            epi = 8 * nf * (th * tw + 8) * 2
            blocks = B * groups * sum(-(-c.hc // th) * -(-c.wc // tw)
                                      for c in classes)
            for nbuf in ((2, 1) if nchunk > 1 else (1,)):
                smem = max((1 + masked) * raw_bytes
                           + nbuf * (a_bytes + w_bytes), epi)
                if smem > _SMEM_MAX:
                    continue
                woffs, off = [], 0
                for c in classes:
                    woffs.append(off)
                    off += groups * nchunk * kc * c.ty * c.tx * 8 * nf
                plan = Plan(kind, C, N, S, OS, kc, th, mf, nf, groups, nbuf,
                            raw_bytes, a_bytes, w_bytes, smem,
                            max(-(-c.wc // tw) for c in classes),
                            max(-(-c.hc // th) for c in classes), blocks,
                            classes, tuple(woffs))
                if blocks >= _MIN_BLOCKS:
                    return plan
                fitting.append(plan)
                break
    if not fitting:
        raise ValueError(f"small conv kernel: no tile fits shared memory for "
                         f"x {tuple(x_shape)}, C_out {c_out}, k {k}")
    return max(fitting, key=lambda p: p.blocks)


def _pack_weights(weight: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Weights for the GEMMs of `plan`, one block after another at
    `plan.woffs`, each [group][chunk][ty·tx][kc][8·nf] (channels padded
    with zeros)."""
    w = weight if plan.kind == "fwd" else weight.transpose(0, 1)
    N, C = w.shape[:2]
    bn, cpad = 8 * plan.nf, -(-C // plan.kc) * plan.kc
    parts = []
    for c in plan.classes:
        ws = w[:, :, list(c.kys)][:, :, :, list(c.kxs)]
        ws = F.pad(ws, (0, 0, 0, 0, 0, cpad - C, 0, plan.groups * bn - N))
        ws = ws.reshape(plan.groups, bn, cpad // plan.kc, plan.kc, c.ty, c.tx)
        parts.append(ws.permute(0, 2, 4, 5, 3, 1).reshape(-1))
    return torch.cat(parts)


_plans: dict = {}
_packed: dict = {}


def _plan_for(kind, x_shape, c_out, k, s, masked):
    key = (kind, tuple(x_shape), c_out, k, s, masked)
    hit = _plans.get(key)
    if hit is None:
        if len(_plans) > 512:
            _plans.clear()
        plan = _plan(kind, x_shape, c_out, k, s, masked)
        rows = [v for c, off in zip(plan.classes, plan.woffs)
                for v in (*c[:8], off)]
        hit = _plans[key] = (plan, (ctypes.c_int * len(rows))(*rows))
    return hit


def _packed_for(weight: torch.Tensor, plan: Plan) -> torch.Tensor:
    """`_pack_weights`, kept while the weight tensor lives unchanged (the
    networks are frozen, so each layer packs once per plan)."""
    key = (id(weight), weight.data_ptr(), weight.dtype, weight.device,
           plan.kind, plan.kc, plan.nf, plan.groups, plan.classes)
    hit = _packed.get(key)
    if hit is not None and hit[0]() is weight and hit[1] == weight._version:
        return hit[2]
    if len(_packed) > 512:
        _packed.clear()
    with torch.no_grad():
        packed = _pack_weights(weight, plan)
    _packed[key] = (weakref.ref(weight), weight._version, packed)
    return packed


def _launch_tc(kind, inp, weight, bias, out, x_shape, stride, act, mask,
               mask_act):
    lib = _build.library("small_conv", _SIGNATURES)
    k = weight.shape[-1]
    plan, rows = _plan_for(kind, x_shape, weight.shape[0], k, stride,
                           mask is not None)
    packed = _packed_for(weight, plan)
    B, C, H, W = inp.shape
    vec = W % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (inp, mask)
                             if t is not None)
    err = lib.pcfa_small_conv_tc(
        inp.data_ptr(), mask.data_ptr() if mask is not None else None,
        packed.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), B, C, H, W, out.shape[1], out.shape[2], out.shape[3],
        plan.S, plan.OS, act, mask_act, plan.kc, plan.th, plan.mf, plan.nf,
        plan.groups, plan.nbuf, vec, plan.raw_bytes, plan.a_bytes,
        plan.w_bytes, plan.smem,
        len(plan.classes), rows, plan.tiles_x, plan.tiles_y,
        torch.cuda.current_stream(inp.device).cuda_stream)
    _build.check(err, f"pcfa_small_conv_tc ({kind})")


# ------------------------------------------------------------- wrappers ---

def _check(x, weight, bias, stride):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"small conv kernel: unsupported dtype {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"small conv kernel: needs CUDA tensors, got "
                         f"{x.device}")
    k = weight.shape[-1]
    if (weight.dim() != 4 or weight.shape[-2] != k or k not in (3, 5, 7)
            or stride not in (1, 2) or x.dim() != 4
            or weight.shape[1] != x.shape[1] or min(x.shape) < 1
            or weight.shape[0] < 1):
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
    if act not in _ACTS:
        raise ValueError(f"small conv: unsupported act {act!r}")
    x = x.contiguous()
    weight = weight.contiguous()
    bias = bias.contiguous() if bias is not None else None
    B, C_in, H, W = x.shape
    C_out, k = weight.shape[0], weight.shape[-1]
    out = torch.empty((B, C_out, _out_size(H, k, stride),
                       _out_size(W, k, stride)), dtype=x.dtype,
                      device=x.device)
    if x.dtype == torch.bfloat16:
        _launch_tc("fwd", x, weight, bias, out, x.shape, stride, _ACTS[act],
                   None, 0)
    else:
        lib = _build.library("small_conv", _SIGNATURES)
        err = lib.pcfa_small_conv_fwd_f32(
            x.data_ptr(), weight.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            B, C_in, H, W, C_out, k, stride, _ACTS[act],
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "pcfa_small_conv_fwd_f32")
    small_conv_fwd.launches += 1
    return out


small_conv_fwd.launches = 0


def small_conv_dx(g: torch.Tensor, weight: torch.Tensor, x_shape,
                  stride: int = 1, out: torch.Tensor | None = None,
                  act: str | None = None) -> torch.Tensor:
    """Launch the dx kernel: the transposed conv in gather form, with the
    derivative of `act` at the forward output `out` applied to g."""
    B, C_in, H, W = (int(v) for v in x_shape)
    C_out, k = weight.shape[0], weight.shape[-1]
    dx = torch.empty((B, C_in, H, W), dtype=g.dtype, device=g.device)
    _check(dx, weight, None, stride)
    o_shape = (B, C_out, _out_size(H, k, stride), _out_size(W, k, stride))
    if g.shape != o_shape:
        raise ValueError(f"small conv kernel: cotangent shape "
                         f"{tuple(g.shape)} does not match the conv")
    if act not in _ACTS:
        raise ValueError(f"small conv: unsupported act {act!r}")
    if act is not None and (out is None or out.shape != o_shape
                            or out.dtype != g.dtype
                            or out.device != g.device):
        raise ValueError(f"small conv kernel: act {act!r} needs the forward "
                         f"output, of shape {o_shape} and g's dtype")
    g = g.contiguous()
    weight = weight.contiguous()
    mask = out.contiguous() if act is not None else None
    if g.dtype == torch.bfloat16:
        _launch_tc("dx", g, weight, None, dx, (B, C_in, H, W), stride, 0,
                   mask, _ACTS[act])
    else:
        lib = _build.library("small_conv", _SIGNATURES)
        err = lib.pcfa_small_conv_dx_f32(
            g.data_ptr(), mask.data_ptr() if mask is not None else None,
            weight.data_ptr(), dx.data_ptr(), B, C_in, H, W, C_out, k,
            stride, _ACTS[act],
            torch.cuda.current_stream(g.device).cuda_stream)
        _build.check(err, "pcfa_small_conv_dx_f32")
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
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = small_conv_dx(g, weight, ctx.x_shape, ctx.stride, out,
                               ctx.act)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            g = _act_grad(g, out, ctx.act)
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
