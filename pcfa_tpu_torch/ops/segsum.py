"""Segment row-sum, the warp's image gradient: CUDA kernel, launch
counter and plain version.

    out[p] = Σ_{i : idx[i] = p} upd[i]     (N, K) rows into `nrows` cells

Replaces the Pallas kernel of `pcfa_tpu/ops/pallas/segsum.py`
(`segment_rows_pallas`). Its sorted, blocked one-hot matmul plan
(`_plan_pairs`, `_sort_pad`) works around a TPU's serial scatter and is
not carried over: the kernel (`csrc/segsum.cu`) is a float32 `atomicAdd`
splat, the form the reference's own CUDA warp backward takes.

The kernel takes float32 rows only (the warp's backward always builds
them in float32, as the TPU kernel takes them) and raises for any other
dtype. The plain version accumulates in float32 (float64 for float64
rows) and returns `upd`'s dtype. Atomics add in an order that changes from
run to run, so results differ from the plain version by float32 rounding.

Bound on the H100 (PWCNet's warps at 384×1280, B = 1): the largest warp
moves ~32 MB (float32 rows in, cells out); memory-bound.

CPU tensors go to the plain version; CUDA tensors launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes

import torch

from pcfa_tpu_torch.ops import _build

_P = ctypes.c_void_p
_SIGNATURES = {
    "pcfa_segsum": [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                    _P],
}


def segment_rows_plain(idx: torch.Tensor, upd: torch.Tensor,
                       nrows: int) -> torch.Tensor:
    """Plain version: `index_add_` into a float32 (float64 for float64
    rows) zero buffer, in `upd`'s dtype."""
    dt = torch.promote_types(upd.dtype, torch.float32)
    out = torch.zeros((nrows, upd.shape[1]), dtype=dt, device=upd.device)
    return out.index_add_(0, idx, upd.to(dt)).to(upd.dtype)


def segment_rows_cuda(idx: torch.Tensor, upd: torch.Tensor,
                      nrows: int) -> torch.Tensor:
    """Launch the kernel (CUDA tensors, float32 rows only). Indices
    outside [0, nrows) are skipped."""
    if upd.dtype != torch.float32:
        raise TypeError(f"segsum kernel: unsupported dtype {upd.dtype}")
    if (upd.dim() != 2 or idx.dim() != 1 or idx.shape[0] != upd.shape[0]
            or idx.device != upd.device or idx.dtype.is_floating_point):
        raise ValueError("segsum kernel: needs integer idx (N,) and upd "
                         "(N, K) on one device")
    lib = _build.library("segsum", _SIGNATURES)
    idx = idx.to(torch.int64).contiguous()
    upd = upd.contiguous()
    N, K = upd.shape
    out = torch.zeros((nrows, K), dtype=torch.float32, device=upd.device)
    stream = torch.cuda.current_stream(upd.device).cuda_stream
    err = lib.pcfa_segsum(idx.data_ptr(), upd.data_ptr(), out.data_ptr(), N,
                          K, nrows, stream)
    _build.check(err, "pcfa_segsum")
    segment_rows_cuda.launches += 1
    return out


segment_rows_cuda.launches = 0


def segment_rows(idx: torch.Tensor, upd: torch.Tensor,
                 nrows: int) -> torch.Tensor:
    """Σ of `upd` rows per cell, (nrows, K). CPU tensors: the plain
    version; CUDA tensors: the kernel."""
    dev = upd.device
    if dev.type == "cpu":
        return segment_rows_plain(idx, upd, nrows)
    if dev.type != "cuda":
        raise ValueError(f"segsum: unsupported device {dev}")
    return segment_rows_cuda(idx, upd, nrows)
