"""The compact L-BFGS direction's two passes over the history: CUDA
kernels, launch counters and plain versions.

With the ring buffers S (steps) and Y (gradient differences), each
(B, m, n), and rows(b) = min(count[b], m) valid rows per pair:

* `hist_products` gives, per valid row i, S[i]·g, S[i]·y, Y[i]·g, Y[i]·y
  and Y[i]·s as (B, 5, m), 0 on the rows past the fill: the projections
  Sᵀg and Yᵀg and the new Gram row and column of `attack/lbfgs.py`'s
  compact direction. g, y and s are rounded to the history's dtype first;
  the sums accumulate in float32 (float64 for a float64 history).
* `hist_combine` gives d = −(γ·g + Σᵢ top[i]·S[i] + γ·Σᵢ bot[i]·Y[i]),
  (B, n) in g's dtype, from the compact solve's coefficients.

Replaces no TPU kernel: the JAX package leaves these products to XLA. The
kernels (`csrc/lbfgs_hist.cu`) read each valid row of S and Y once per
pass, in the storage dtype; the plain versions (`_hist_products`,
`_hist_combine`) copy each chunk of columns to float32 and multiply it as
a batched matrix product, over all m rows.

Bound on the H100: bytes. At 16 KITTI pairs (m = 100, n = 2,815,488,
bf16 history) a full ring is 18.02 GB: 5.54 ms for the products and 5.49
ms for the combine at 3.35 TB/s.

The products kernel's slabs of columns are planned here: about `_WAVES`
waves of the card's resident blocks over the B pairs, each slab a multiple
of 8 columns, so the sums' order, and so their bits, depend only on the
card and the shapes. The kernels read 16-byte pieces: they take n a
multiple of 8 and 16-byte aligned buffers, as every main path gives them.

CPU tensors go to the plain versions; CUDA tensors launch the kernels or
raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pcfa_tpu_torch.ops import _build
from pcfa_tpu_torch.utils import profiling

# columns per chunk when the history is multiplied in float32, which
# bounds the float32 temporaries to B·m·_CHUNK elements; each chunk's
# reduction is cut into blocks of _SPLIT columns that form a batch axis
# (split-K): a product whose reduction runs over millions of columns as one
# matrix product gets only a handful of thread blocks on a GPU
_CHUNK = 1 << 18
_SPLIT = 1 << 12

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "pcfa_lbfgs_hist_plan": [_I, _I, _I, ctypes.POINTER(_I)],
    "pcfa_lbfgs_hist_products": [_P] * 8 + [_I, _I, _I, _I, _L, _I, _L, _P],
    "pcfa_lbfgs_hist_combine": [_P] * 8 + [_I, _I, _I, _I, _L, _P],
}
_HIST_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
_X_CODES = {torch.float32: 1, torch.float64: 2}
_WAVES = 2          # resident-block waves the products' slabs fill
_ALIGN = 8          # n and a slab's columns: whole 16-byte bf16 pieces
_MIN_SLAB = 256     # ... and at least one warp step (32 lanes × 8)
_MAX_HISTORY = 4096


def _hist_products(buf: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """buf (B, m, n) @ rhs (B, n, k) → (B, m, k) in float32 (float64 for a
    float64 history), accumulated in that dtype: per chunk of columns, one
    copy to it laid out as (B, blocks, m, _SPLIT), a batched product per
    block, and a sum over the blocks."""
    B, m, n = buf.shape
    k = rhs.shape[-1]
    f32 = torch.promote_types(buf.dtype, torch.float32)
    out = torch.zeros((B, m, k), dtype=f32, device=buf.device)
    for i in range(0, n, _CHUNK):
        end = min(i + _CHUNK, n)
        blocks = (end - i) // _SPLIT
        j = i + blocks * _SPLIT
        if blocks:
            a = buf[:, :, i:j].reshape(B, m, blocks, _SPLIT).transpose(1, 2)
            a = a.to(f32, memory_format=torch.contiguous_format)
            r = rhs[:, i:j].reshape(B, blocks, _SPLIT, k).to(f32)
            out += torch.matmul(a, r).sum(1)
        if j < end:
            out += torch.bmm(buf[:, :, j:end].to(f32), rhs[:, j:end].to(f32))
    return out


def _hist_combine(coef: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """Σᵢ coef[:, i]·buf[:, i] → (B, n) in coef's dtype (float32, or
    float64 in a float64 problem), with the buffer cast to it chunk by
    chunk."""
    c = coef[:, None, :]
    if buf.dtype == coef.dtype:
        return torch.bmm(c, buf)[:, 0]
    return torch.cat([torch.bmm(c, buf[:, :, i:i + _CHUNK].to(coef.dtype))
                      for i in range(0, buf.shape[-1], _CHUNK)], dim=2)[:, 0]


def _valid(count: torch.Tensor, m: int) -> torch.Tensor:
    """(B, m): ring row i holds a pair, i < min(count, m)."""
    return torch.arange(m, device=count.device) < count.clamp(max=m)[:, None]


def hist_products_plain(s_buf, y_buf, grad, y, s, count) -> torch.Tensor:
    """(B, 5, m): S·g, S·y, Y·g, Y·y, Y·s per ring row, 0 past the fill;
    g, y, s rounded to the history's dtype."""
    rhs = torch.stack([grad, y, s], dim=2).to(s_buf.dtype)     # (B, n, 3)
    prods = torch.cat([_hist_products(s_buf, rhs[..., :2]),
                       _hist_products(y_buf, rhs)], dim=2)     # (B, m, 5)
    valid = _valid(count, s_buf.shape[1])
    return torch.where(valid[:, None, :], prods.transpose(1, 2), 0.0)


def hist_combine_plain(s_buf, y_buf, grad, top, bot, gamma,
                       count) -> torch.Tensor:
    """−(γ·g + Σᵢ top[i]·S[i] + γ·Σᵢ bot[i]·Y[i]) over the valid rows,
    (B, n) in g's dtype."""
    valid = _valid(count, s_buf.shape[1])
    top = torch.where(valid, top, 0.0)
    bot = torch.where(valid, bot, 0.0)
    gamma = gamma[:, None]
    return -(gamma * grad + _hist_combine(top, s_buf)
             + gamma * _hist_combine(bot, y_buf))


def _check(s_buf, y_buf, vecs, count, what):
    """What the kernels take, else ValueError naming it; returns (B, m, n)."""
    B, m, n = s_buf.shape
    dev = s_buf.device
    if (y_buf.shape != s_buf.shape or y_buf.dtype != s_buf.dtype
            or s_buf.dtype not in _HIST_CODES
            or not (s_buf.is_contiguous() and y_buf.is_contiguous())):
        raise ValueError(f"{what}: needs contiguous S and Y of one shape "
                         f"(B, m, n) in bf16, float32 or float64")
    xdt = vecs[0].dtype
    if xdt not in _X_CODES or any(
            v.dtype != xdt or v.device != dev
            or v.shape != (B, n) for v in vecs):
        raise ValueError(f"{what}: needs the vectors as (B, n) float32 or "
                         f"float64 of one dtype on S's device")
    if count.shape != (B,) or count.dtype != torch.int64 \
            or count.device != dev:
        raise ValueError(f"{what}: needs an int64 count (B,) on S's device")
    if not 0 < m <= _MAX_HISTORY:
        raise ValueError(f"{what}: history size {m} outside 1..{_MAX_HISTORY}")
    if n % _ALIGN:
        raise ValueError(f"{what}: n = {n} is not a multiple of {_ALIGN}")
    for name, t in zip("SYgys", [s_buf, y_buf, *vecs]):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")
    return B, m, n


@functools.lru_cache(maxsize=None)
def _resident(device: int, t_code: int, x_code: int, m: int) -> int:
    """Resident blocks of the products kernel on the card."""
    lib = _build.library("lbfgs_hist", _SIGNATURES)
    per_sm = _I(0)
    with torch.cuda.device(device):
        _build.check(lib.pcfa_lbfgs_hist_plan(t_code, x_code, m,
                                              ctypes.byref(per_sm)),
                     "pcfa_lbfgs_hist_plan")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, per_sm.value) * sms


def plan_slabs(B: int, n: int, resident: int) -> tuple[int, int]:
    """(slabs per pair, columns per slab): about `_WAVES` waves of
    `resident` blocks over the B pairs, a multiple of 8 columns a slab and
    at least a warp's step."""
    want = max(1, _WAVES * resident // B)
    per = max(-(-n // want), _MIN_SLAB)
    per = -(-per // _ALIGN) * _ALIGN
    return -(-n // per), per


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@profiling.launch_counted
def hist_products_cuda(s_buf, y_buf, grad, y, s, count) -> torch.Tensor:
    """Launch the products kernel and its reduction over the slabs (CUDA
    tensors). Same arguments and result as `hist_products_plain`."""
    vecs = [v.contiguous() for v in (grad, y, s)]
    B, m, n = _check(s_buf, y_buf, vecs, count, "L-BFGS history products")
    acc = torch.promote_types(s_buf.dtype, torch.float32)
    codes = _HIST_CODES[s_buf.dtype], _X_CODES[vecs[0].dtype]
    dev = s_buf.device
    slabs, per = plan_slabs(B, n, _resident(dev.index, *codes, m))
    ws = torch.empty((B, slabs, 5, m), dtype=acc, device=dev)
    out = torch.empty((B, 5, m), dtype=acc, device=dev)
    lib = _build.library("lbfgs_hist", _SIGNATURES)
    err = lib.pcfa_lbfgs_hist_products(
        s_buf.data_ptr(), y_buf.data_ptr(), *(v.data_ptr() for v in vecs),
        count.data_ptr(), ws.data_ptr(), out.data_ptr(), *codes, B, m, n,
        slabs, per, _stream(s_buf))
    _build.check(err, "pcfa_lbfgs_hist_products")
    hist_products_cuda.launches += 1
    return out


@profiling.launch_counted
def hist_combine_cuda(s_buf, y_buf, grad, top, bot, gamma,
                      count) -> torch.Tensor:
    """Launch the combine kernel (CUDA tensors). Same arguments and result
    as `hist_combine_plain`."""
    grad = grad.contiguous()
    B, m, n = _check(s_buf, y_buf, [grad], count, "L-BFGS history combine")
    coefs = [c.contiguous() for c in (top, bot)]
    gamma = gamma.contiguous()
    if any(c.shape != (B, m) or c.dtype != grad.dtype
           or c.device != grad.device for c in coefs) \
            or gamma.shape != (B,) or gamma.dtype != grad.dtype \
            or gamma.device != grad.device:
        raise ValueError("L-BFGS history combine: needs top, bot (B, m) and "
                         "gamma (B,) in g's dtype on its device")
    d = torch.empty_like(grad)
    lib = _build.library("lbfgs_hist", _SIGNATURES)
    err = lib.pcfa_lbfgs_hist_combine(
        s_buf.data_ptr(), y_buf.data_ptr(), grad.data_ptr(),
        coefs[0].data_ptr(), coefs[1].data_ptr(), gamma.data_ptr(),
        count.data_ptr(), d.data_ptr(), _HIST_CODES[s_buf.dtype],
        _X_CODES[grad.dtype], B, m, n, _stream(s_buf))
    _build.check(err, "pcfa_lbfgs_hist_combine")
    hist_combine_cuda.launches += 1
    return d


def _route(s_buf, what):
    dev = s_buf.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev.type == "cuda"


def hist_products(s_buf, y_buf, grad, y, s, count) -> torch.Tensor:
    """(B, 5, m) products of the history with g, y, s. CPU tensors: the
    plain version; CUDA tensors: the kernel."""
    fn = hist_products_cuda if _route(s_buf, "L-BFGS history products") \
        else hist_products_plain
    return fn(s_buf, y_buf, grad, y, s, count)


def hist_combine(s_buf, y_buf, grad, top, bot, gamma, count) -> torch.Tensor:
    """The direction −(γ·g + top·S + γ·bot·Y), (B, n). CPU tensors: the
    plain version; CUDA tensors: the kernel."""
    fn = hist_combine_cuda if _route(s_buf, "L-BFGS history combine") \
        else hist_combine_plain
    return fn(s_buf, y_buf, grad, top, bot, gamma, count)
