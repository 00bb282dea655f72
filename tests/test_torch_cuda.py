"""Each CUDA kernel of `pcfa_tpu_torch` vs its plain PyTorch version, on the
card. Every test is marked `cuda` and skips where CUDA is not available.

The file imports neither JAX nor `pcfa_tpu`, so it runs on a GPU machine
without them (`--noconftest` skips the JAX set-up of tests/conftest.py):
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, relative to the values' scale: a float32 conv kernel and the
plain float32 version (cuDNN with TF32 off) differ only in summation order
(1e-4 for up to 576 products). The plain lookup goes through
`grid_sample`, whose normalize/unnormalize round trip moves each sample
position by up to ~1e-5 px at x ≈ 150; on random maps that is ~1e-5 of the
values (1e-4 leaves room). A bf16 kernel accumulates in float32 and rounds
its output once; the plain version computes in float32 from the same bf16
inputs, so they differ by bf16 rounding (3e-2).
"""

import numpy as np
import pytest
import torch

from pcfa_tpu_torch.ops import corr_lookup as cl
from pcfa_tpu_torch.ops import small_conv as sc

R = 4
P = 2 * R + 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    from pcfa_tpu_torch._device import resolve_device

    return resolve_device("cuda")  # TF32 off: float32 means float32


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, ref, tol):
    got, ref = got.float(), ref.float()
    scale = max(1.0, float(ref.abs().max()))
    diff = (got - ref).abs().nan_to_num(nan=float("inf"))
    err = float(diff.max())
    at = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
    assert err <= tol * scale, (f"max abs err {err} > {tol} × {scale} at "
                                f"{at}: kernel {float(got[at])}, plain "
                                f"{float(ref[at])}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_corr_lookup_kernel_matches_plain(rng, cuda, dtype, tol):
    """Forward and backward on the KITTI pyramid's level sizes for 256
    queries, with in-map, border, out-of-map and non-finite coordinates."""
    shapes = [(47, 156), (23, 78), (11, 39), (5, 19)]
    n = 256
    levels = [_t(rng.standard_normal((n, h, w))).to(cuda, dtype)
              for h, w in shapes]
    c = _t(rng.uniform(-8, 164, (n, 2))).to(cuda)
    c[0] = torch.tensor([0.0, 0.0])
    c[1] = torch.tensor([155.0, 46.0])
    c[2] = torch.tensor([-40.0, 100.0])
    # coords beyond any map, and non-finite ones, must not index out of
    # bounds; the kernel returns zeros there (grid_sample on CUDA gives NaN
    # for |x| ~ 1e30, so those rows are not compared with it)
    c[3] = torch.tensor([1e30, -1e30])
    c[4] = torch.tensor([-3e9, 7.0])
    c[5] = float("nan")
    c[6] = float("inf")
    keep = torch.isfinite(c).all(1) & (c.abs() < 1e6).all(1)
    before = cl.corr_window_fwd.launches
    out = cl.corr_window_fwd(levels, c, R)
    torch.cuda.synchronize()
    assert cl.corr_window_fwd.launches == before + 1
    assert out.shape == (n, 4 * P * P) and out.dtype == dtype
    _close(out[keep], cl.corr_window_plain(levels, c, R)[keep], tol)
    assert torch.count_nonzero(out[3:5]) == 0

    g = _t(rng.standard_normal(tuple(out.shape))).to(cuda, dtype)
    g[~keep] = 0
    got = cl.corr_window_bwd(g, levels, c, R)
    ref = cl.corr_window_bwd_plain(g, levels, c, R)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        _close(a[keep], b[keep], tol)
        assert torch.count_nonzero(a[~keep]) == 0


@pytest.mark.cuda
def test_corr_lookup_autograd_on_card(rng, cuda):
    """The dispatch runs the kernel on CUDA tensors, in both directions."""
    from pcfa_tpu_torch.ops.correlation import corr_lookup_window

    levels = [_t(rng.standard_normal((24, h, w))).to(cuda).requires_grad_()
              for h, w in [(12, 16), (6, 8), (3, 4), (2, 2)]]
    coords = _t(rng.uniform(-2, 18, (2, 3, 4, 2))).to(cuda)
    f, b = cl.corr_window_fwd.launches, cl.corr_window_bwd.launches
    out = corr_lookup_window(levels, coords, R)
    out.square().sum().backward()
    assert (cl.corr_window_fwd.launches, cl.corr_window_bwd.launches) == (
        f + 1, b + 1)
    ref = [lv.detach().requires_grad_() for lv in levels]
    cl.corr_window_plain(ref, coords.reshape(-1, 2), R).square().sum() \
        .backward()
    for a, r in zip(levels, ref):
        _close(a.grad, r.grad, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", [
    # (B, C_in, H, W, C_out, k, stride, act)
    (2, 3, 64, 96, 64, 7, 2, None),
    (2, 64, 32, 48, 64, 3, 1, "relu"),
    (1, 3, 37, 51, 20, 5, 2, "leaky"),
    (1, 6, 17, 19, 3, 3, 1, None),
    (1, 5, 15, 9, 7, 3, 2, "relu"),
])
def test_small_conv_kernel_matches_plain(rng, cuda, dtype, tol, case):
    B, C_in, H, W, C_out, k, s, act = case
    x = _t(rng.standard_normal((B, C_in, H, W))).to(cuda, dtype)
    w = _t(rng.standard_normal((C_out, C_in, k, k)) / np.sqrt(C_in * k * k))
    w = w.to(cuda, dtype)
    b = _t(rng.standard_normal(C_out)).to(cuda, dtype)
    out = sc.small_conv_fwd(x, w, b, s, act)
    assert out.shape == (B, C_out, -(-H // s), -(-W // s))
    _close(out, sc.conv_plain(x.float(), w.float(), b.float(), s, act), tol)
    g = _t(rng.standard_normal(tuple(out.shape))).to(cuda, dtype)
    dx = sc.small_conv_dx(g, w, x.shape, s)
    torch.cuda.synchronize()
    _close(dx, sc.conv_dx_plain(g.float(), w.float(), x.shape, s), tol)


@pytest.mark.cuda
def test_small_conv_autograd_on_card(rng, cuda):
    x = _t(rng.standard_normal((1, 3, 20, 22))).to(cuda).requires_grad_()
    w = _t(rng.standard_normal((8, 3, 7, 7)) * 0.1).to(cuda)
    b = _t(rng.standard_normal(8)).to(cuda)
    f, d = sc.small_conv_fwd.launches, sc.small_conv_dx.launches
    sc.small_conv2d(x, w, b, 2, "relu").square().sum().backward()
    assert (sc.small_conv_fwd.launches, sc.small_conv_dx.launches) == (
        f + 1, d + 1)
    xr = x.detach().requires_grad_()
    sc.conv_plain(xr, w, b, 2, "relu").square().sum().backward()
    _close(x.grad, xr.grad, 1e-4)
