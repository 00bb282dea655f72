"""Patch correlation of two channels-last feature maps: CUDA kernels
(forward and backward), their per-shape plan, autograd wrapper, launch
counters and plain versions.

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
memory-bound; the largest (96×320, C = 32) moves ~9 MB per forward.

Design (`csrc/local_corr.cu` has the details). A block owns `th` output
rows (stride rows apart) × 16·`mf` columns and stages, once per channel
chunk, its f1 tile and the feature halo rows those rows meet. bfloat16
runs banded products on the tensor cores: the forward a 16 × (16+2R)
product of 16 pixels with their halo per (row, shift row), of which it
keeps the band; the backward, df1 and df2 in one launch, a product of a
band matrix built from g with the staged halo per shift row. float32
keeps the CUDA cores on the same tiling; its forward gives each thread a
pixel and the rows of one diagonal r + iy = h, which read the same f2
values. `_plan` picks per shape the tile, the forward's shift rows per
block (`pb`) and k split across warps, the backward's channel chunks per
block and how it stages g, double buffering and the block size, so that
PWCNet's levels 2–4 and FlowNetC launch at least one wave of the 132 SMs
and the small levels split their channels across warps or blocks
(bfloat16; float32's forward is ranked by its threads' instructions).

CPU tensors go to the plain versions; CUDA tensors launch the kernels or
raise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from pcfa_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "pcfa_local_corr_fwd": [_I, _P, _P, _P] + [_I] * 6
    + [ctypes.POINTER(_I), _I, _P],
    "pcfa_local_corr_bwd": [_I, _P, _P, _P, _P, _P] + [_I] * 6
    + [ctypes.POINTER(_I), _I, _P],
}
MAX_PATCH = 21
MAX_RADIUS = 20

_SMS = 132                    # H100 SMs: one wave of blocks
_SMEM_MAX = 232448            # shared memory a block may use
_SMEM_SM = 233472             # shared memory of one SM
_THREADS = 256
# (th, mf): output rows and 16-pixel fragments per row of a block
_TILES = ((8, 2), (8, 1), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))
# the ints the kernels take, in `struct Plan`'s order (csrc/local_corr.cu)
PLAN_FIELDS = ("th", "mf", "nf", "pb", "kc", "nchunk", "ksplit", "cgroups",
               "nbuf", "threads", "hws", "rows", "pitch", "stage_bytes",
               "g_bytes", "smem", "gx", "gy", "gz", "gmode", "gcap", "ngroup")


class Plan(NamedTuple):
    """One launch (csrc/local_corr.cu's `struct Plan` says what each
    field is). Rows of a block are y = ybase + r·stride (r < th). `blocks`
    and `staged` (bytes all blocks stage, the base of the cost that
    `_candidates` ranks by) stay in Python."""
    th: int
    mf: int
    nf: int
    pb: int
    kc: int
    nchunk: int
    ksplit: int
    cgroups: int
    nbuf: int
    threads: int
    hws: int
    rows: int
    pitch: int
    stage_bytes: int
    g_bytes: int
    out_bytes: int
    smem: int
    gx: int
    gy: int
    gz: int
    gmode: int
    gcap: int
    ngroup: int
    blocks: int
    staged: int


def _round(n: int, to: int = 128) -> int:
    return -(-n // to) * to


def _f32_runs(th: int, pb: int, patch: int) -> list[int]:
    """The rows of each float32 forward thread of one pixel column: runs
    of up to 4 rows (patch ≤ 9; else 2) on each diagonal r + iy = h (the
    kernel's `f32_item` and `f32_rows`; `f32_runs` counts them)."""
    q = 4 if patch <= 9 else 2
    runs = []
    for h in range(th + pb - 1):
        n = min(th - 1, h) - max(0, h - pb + 1) + 1
        runs += [min(q, n - i) for i in range(0, n, q)]
    return runs


def _pitch(kind: str, kc: int, esz: int) -> int:
    """Bytes per staged pixel: bf16, an odd number of 16-byte units
    (ldmatrix rows on distinct banks); float32 forward, an odd number of
    words (lanes on neighbouring pixels); float32 backward, dense (lanes
    on neighbouring channels)."""
    if esz == 2:
        return ((kc // 8) | 1) * 16
    return (kc + 1) * 4 if kind == "fwd" else kc * 4


def _plan(kind: str, B: int, H: int, W: int, C: int, patch: int,
          stride: int, esz: int) -> Plan:
    """Tile, shift-row split (forward), channel chunks and their blocks
    and g's staging (backward) and buffering for one launch: the plan
    `_candidates` ranks first."""
    best = min(_candidates(kind, B, H, W, C, patch, stride, esz),
               key=lambda kp: kp[0], default=None)
    if best is None:
        raise ValueError(f"local corr kernel: no plan for {kind} at "
                         f"({B}, {H}, {W}, {C}), patch {patch}, stride "
                         f"{stride}")
    return best[1]


def _candidates(kind: str, B: int, H: int, W: int, C: int, patch: int,
                stride: int, esz: int):
    """(rank key, plan) of every plan that fits a block's shared memory
    and the grid. Plans with at least one block per SM rank first (else
    the most blocks), then the lowest cost."""
    R = (patch - 1) // 2 * stride
    c16 = -(-C // 16) * 16
    P2 = patch * patch
    V = 16 // esz  # elements per 16-byte copy
    f32_fwd = kind == "fwd" and esz == 4
    for kc in [c16] + [k for k in (128, 64, 32, 16) if k < c16]:
        nchunk = -(-C // kc)
        pitch = _pitch(kind, kc, esz)
        for th, mf in _TILES:
            tw = 16 * mf
            gx = -(-W // tw)
            gy = stride * -(-(-(-H // stride)) // th)
            if gy > 65535:
                continue
            if kind == "fwd":
                nf = -(-(16 + 2 * R) // 8)
                hws = 16 * (mf - 1) + 8 * nf
                shapes = []
                for pb in sorted({-(-patch // s) for s in range(1, patch + 1)},
                                 reverse=True):
                    rows = th + pb - 1
                    px = th * tw + rows * hws
                    shapes.append((pb, rows, 1, nchunk, _round(px * pitch), 0,
                                   _round(th * tw * pb * patch * 4),
                                   B * -(-patch // pb), px * c16, 0, 0))
            else:
                nf = -(-(16 + 2 * R) // 16)
                hws = 16 * (mf - 1) + 16 * nf
                rows = th + patch - 1
                shapes = []
                for gmode in (1, 0):
                    gcap = V * -(-((hws if gmode else tw) * P2 + V - 1) // V)
                    g_el = (th * gcap, rows * gcap if gmode
                            else th * patch * hws * patch)
                    cgs = set()
                    for per in range(nchunk, 0, -1):  # chunks per block
                        cg = -(-nchunk // per)
                        if cg in cgs:
                            continue
                        cgs.add(cg)
                        shapes.append((patch, rows, cg, per,
                                       _round(rows * hws * pitch),
                                       _round(max(g_el) * esz), 0, B * cg * 2,
                                       sum(g_el) // 2 + per * rows * hws * kc,
                                       gmode, gcap))
            # px: elements a block stages (the backward: df1's and df2's mean)
            for (pb, rows, cg, per, stage, g_b, out_b, gz, px, gmode,
                 gcap) in shapes:
                for nbuf in ((2, 1) if per > 1 else (1,)):
                    smem = g_b + nbuf * stage + out_b
                    if smem <= _SMEM_MAX:
                        break
                else:
                    continue
                if gz > 65535:
                    continue
                blocks = gx * gy * gz
                staged = blocks * px * esz
                ks, warps = kc // 16, _THREADS // 32
                ksplit = ngroup = 1
                while (kind == "fwd" and esz == 2
                       and th * pb * mf * ksplit < warps
                       and 2 * ksplit <= ks):
                    ksplit *= 2
                while (kind == "bwd" and esz == 2 and ngroup < 4
                       and ks % (2 * ngroup) == 0
                       and th * mf * ks // (2 * ngroup) >= warps):
                    ngroup *= 2
                # one block per SM: twice the warps, to keep 16 per SM
                half = smem > _SMEM_MAX // 2
                threads = _THREADS * (2 if half else 1)
                if f32_fwd:  # a thread per item, its sums in registers
                    runs = _f32_runs(th, pb, patch)
                    items = 16 * mf * len(runs)
                    if items > _THREADS:
                        continue
                    threads = _THREADS
                plan = Plan(th, mf, nf, pb, kc, nchunk, ksplit, cg, nbuf,
                            threads, hws, rows, pitch, stage, g_b, out_b,
                            smem, gx, gy, gz, gmode, gcap, ngroup, blocks,
                            staged)
                # The cost: bytes staged, weighted by what the staging and
                # the MMAs cost beyond them (weights fitted to graph-timed
                # runs of PWCNet's levels and FlowNetC on an H100, see
                # `sweep_local_corr.py`). Forward: a k split adds atomics,
                # each further chunk adds its bands into the out tile
                # again, a shift-row split breaks the output span.
                # Backward: g copied element by element costs ~8× a
                # 16-byte copy per byte; further chunks in a block cost
                # their barriers; a band of g serves 2·ngroup MMAs; one
                # block per SM hides less latency. float32's forward: the
                # longest thread's chain of loads and FMAs (per channel
                # patch·n + patch + n for n rows), once per wave of
                # resident blocks (two, by the kernel's registers), plus
                # an SM's share of the shared-memory loads, one warp's per
                # cycle.
                if f32_fwd:
                    cpad = nchunk * kc
                    resident = min(_SMEM_SM // (smem + 1024), 2)
                    waves = -(-blocks // (_SMS * resident))
                    chain = max(cpad * (patch * n + patch + n) for n in runs)
                    loads = 16 * mf * sum(cpad * (patch + n) for n in runs)
                    cost = (4 * waves * chain
                            + -(-blocks // _SMS) * loads / 32)
                elif kind == "fwd":
                    cost = (staged * (1.5 if ksplit > 1 else 1)
                            * (1 + 0.5 * (nchunk - 1))
                            * (1.25 if pb < patch else 1))
                else:
                    runs = 0 if gmode else th * patch * hws * patch
                    cost = ((staged + 7 * runs * esz * blocks // 2)
                            * (1 + 0.25 * (per - 1)) / ngroup ** 0.5
                            * (2 if half else 1))
                # the cost of float32's forward counts its waves itself
                full = blocks >= _SMS or f32_fwd
                yield (not full, 0 if full else -blocks, cost, -nbuf), plan


_plans: dict = {}


def _plan_for(kind, shape, patch, stride, esz):
    key = (kind, tuple(shape), patch, stride, esz)
    hit = _plans.get(key)
    if hit is None:
        if len(_plans) > 512:
            _plans.clear()
        plan = _plan(kind, *shape, patch, stride, esz)
        ints = [getattr(plan, f) for f in PLAN_FIELDS]
        hit = _plans[key] = (plan, (_I * len(ints))(*ints))
    return hit


def _copy_bytes(plan: Plan, C: int, *ts: torch.Tensor) -> int:
    """Bytes per staging copy: the widest of 16, 8, 4 that divides a
    pixel's channels, the staged pitch and every map's address (2: bf16
    element by element)."""
    esz = ts[0].element_size()
    for ub in (16, 8, 4):
        if ((C * esz) % ub == 0 and plan.pitch % ub == 0
                and all(t.data_ptr() % ub == 0 for t in ts)):
            return ub
    return 2


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
    plan, ints = _plan_for("fwd", fmap1.shape, patch, stride,
                           fmap1.element_size())
    out = torch.empty((B, H, W, patch * patch), dtype=fmap1.dtype,
                      device=fmap1.device)
    stream = torch.cuda.current_stream(fmap1.device).cuda_stream
    err = lib.pcfa_local_corr_fwd(
        _DTYPES[fmap1.dtype], fmap1.data_ptr(), fmap2.data_ptr(),
        out.data_ptr(), B, H, W, C, patch, stride, ints,
        _copy_bytes(plan, C, fmap1, fmap2), stream)
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
    # PWCNet's cotangent arrives contiguous (the leaky ReLU's backward
    # keeps the correlation's layout), so this copies nothing there; the
    # kernel copies g in 16-byte pieces
    g = g.to(fmap1.dtype).contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    if g.shape != (B, H, W, patch * patch) or g.device != fmap1.device:
        raise ValueError(f"local corr kernel: cotangent {tuple(g.shape)} "
                         f"on {g.device} != {(B, H, W, patch * patch)} on "
                         f"{fmap1.device}")
    lib = _build.library("local_corr", _SIGNATURES)
    plan, ints = _plan_for("bwd", fmap1.shape, patch, stride,
                           fmap1.element_size())
    df1 = torch.empty_like(fmap1)
    df2 = torch.empty_like(fmap2)
    stream = torch.cuda.current_stream(fmap1.device).cuda_stream
    err = lib.pcfa_local_corr_bwd(
        _DTYPES[fmap1.dtype], fmap1.data_ptr(), fmap2.data_ptr(),
        g.data_ptr(), df1.data_ptr(), df2.data_ptr(), B, H, W, C, patch,
        stride, ints, _copy_bytes(plan, C, fmap1, fmap2), stream)
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
