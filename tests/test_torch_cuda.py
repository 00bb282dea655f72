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
inputs, so they differ by bf16 rounding (3e-2). The patch correlation's
kernel and plain version are float32 sums of the same products in another
order (1e-4), each rounded once to bf16 (one bf16 ulp, ≤ 2⁻⁷ of a value:
1e-2). The scale is the plain result's largest magnitude, with no floor,
so a limit stays relative to values well under 1.
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
    scale = float(ref.abs().max()) or 1.0
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
    (2, 16, 48, 80, 32, 3, 2, "leaky"),   # PWCNet's k3 s2 pyramid convs
    (1, 64, 24, 40, 32, 3, 1, "leaky"),   # PWCNet's dc_conv6
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
@pytest.mark.parametrize("case", [
    # (C_in, H, W, C_out, k, act): RAFT's stem route; PWCNet's k3 s2
    # pyramid convs with the leaky epilogue
    (3, 20, 22, 8, 7, "relu"),
    (16, 24, 40, 32, 3, "leaky"),
])
def test_small_conv_autograd_on_card(rng, cuda, case):
    """Stride 2 through the autograd path: one forward and one dx launch;
    dx is the dx kernel on the cotangent masked by the kernel's own
    output (relu: 0 where ≤ 0; leaky: 0.1)."""
    C_in, H, W, C_out, k, act = case
    x = _t(rng.standard_normal((1, C_in, H, W))).to(cuda).requires_grad_()
    w = _t(rng.standard_normal((C_out, C_in, k, k))
           / np.sqrt(C_in * k * k)).to(cuda)
    b = _t(rng.standard_normal(C_out)).to(cuda)
    f, d = sc.small_conv_fwd.launches, sc.small_conv_dx.launches
    out = sc.small_conv2d(x, w, b, 2, act)
    g = _t(rng.standard_normal(tuple(out.shape))).to(cuda)
    out.backward(g)
    assert (sc.small_conv_fwd.launches, sc.small_conv_dx.launches) == (
        f + 1, d + 1)
    out = out.detach()
    _close(out, sc.conv_plain(x.detach(), w, b, 2, act), 1e-4)
    gm = g * torch.where(out > 0, 1.0, 0.1 if act == "leaky" else 0.0)
    _close(x.grad, sc.conv_dx_plain(gm, w, x.shape, 2), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("case", [
    # (B, H, W, C, patch, stride)
    (1, 6, 20, 196, 9, 1),     # PWCNet level 6 at 384×1280
    (1, 24, 80, 96, 9, 1),     # level 4
    (2, 7, 45, 33, 5, 1),      # odd sizes, ragged channel chunk
    (1, 2, 3, 5, 9, 1),        # map smaller than the patch
    (1, 20, 40, 256, 21, 2),   # FlowNetC's patch and stride
])
def test_local_corr_kernel_matches_plain(rng, cuda, dtype, tol, case):
    from pcfa_tpu_torch.ops import local_corr as lc

    B, H, W, C, patch, stride = case
    f1 = _t(rng.standard_normal((B, H, W, C))).to(cuda, dtype)
    f2 = _t(rng.standard_normal((B, H, W, C))).to(cuda, dtype)
    before = (lc.local_corr_fwd.launches, lc.local_corr_bwd.launches)
    out = lc.local_corr_fwd(f1, f2, patch, stride)
    torch.cuda.synchronize()
    assert out.shape == (B, H, W, patch * patch) and out.dtype == dtype
    _close(out, lc.local_corr_plain(f1, f2, patch, stride), tol)
    g = _t(rng.standard_normal(tuple(out.shape))).to(cuda, dtype)
    got = lc.local_corr_bwd(g, f1, f2, patch, stride)
    ref = lc.local_corr_bwd_plain(g, f1, f2, patch, stride)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.dtype == dtype
        _close(a, b, tol)
    assert (lc.local_corr_fwd.launches, lc.local_corr_bwd.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_local_corr_autograd_on_card(rng, cuda):
    from pcfa_tpu_torch.ops import local_corr as lc

    f1 = _t(rng.standard_normal((2, 12, 40, 32))).to(cuda).requires_grad_()
    f2 = _t(rng.standard_normal((2, 12, 40, 32))).to(cuda).requires_grad_()
    f, b = lc.local_corr_fwd.launches, lc.local_corr_bwd.launches
    lc.local_corr(f1, f2, 9, 1).square().sum().backward()
    assert (lc.local_corr_fwd.launches, lc.local_corr_bwd.launches) == (
        f + 1, b + 1)
    r1, r2 = (t.detach().requires_grad_() for t in (f1, f2))
    lc.local_corr_plain(r1, r2, 9, 1).square().sum().backward()
    _close(f1.grad, r1.grad, 1e-4)
    _close(f2.grad, r2.grad, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["warp", "one_cell", "out_of_range"])
def test_segsum_kernel_matches_float64(rng, cuda, case):
    """Against a float64 truth: float32 atomics add in a varying order, so
    the rows are held to atol 2e-5 / rtol 2e-4 (as the JAX package's
    segsum tests). Indices outside [0, nrows) are skipped."""
    from pcfa_tpu_torch.ops import segsum as sg

    N, K, nrows = 7680, 256, 7889   # PWCNet's level-3 warp at 384×1280
    idx = rng.integers(0, nrows, N)
    if case == "one_cell":
        idx[:4000] = 17
    elif case == "out_of_range":
        idx[::7] = nrows + 3
        idx[1::7] = -1
    upd = _t(rng.standard_normal((N, K)))
    keep = (idx >= 0) & (idx < nrows)
    want = np.zeros((nrows, K))
    np.add.at(want, idx[keep], upd.double().numpy()[keep])
    before = sg.segment_rows_cuda.launches
    got = sg.segment_rows(torch.from_numpy(idx).to(cuda), upd.to(cuda), nrows)
    torch.cuda.synchronize()
    assert sg.segment_rows_cuda.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (nrows, K)
    np.testing.assert_allclose(got.double().cpu().numpy(), want, atol=2e-5,
                               rtol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_segsum_kernel_takes_float32_rows_only(cuda, dtype):
    from pcfa_tpu_torch.ops import segsum as sg

    idx = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        sg.segment_rows(idx, torch.ones((4, 3), dtype=dtype, device=cuda), 2)


@pytest.mark.cuda
def test_grid_sample_autograd_on_card(rng, cuda):
    """The packed sampler on the card: d img through the segsum kernel,
    against the same sampler on the CPU (plain row-sum)."""
    from pcfa_tpu_torch.ops import segsum as sg
    from pcfa_tpu_torch.ops.warp import grid_sample

    img = _t(rng.standard_normal((2, 24, 80, 32)))
    grid = _t(rng.uniform(-1.2, 1.2, (2, 24, 80, 2)))
    g = _t(rng.standard_normal((2, 24, 80, 32)))
    res = {}
    for dev in ("cpu", cuda):
        a = img.to(dev).detach().requires_grad_()
        b = grid.to(dev).detach().requires_grad_()
        (grid_sample(a, b) * g.to(dev)).sum().backward()
        res[str(dev)] = (a.grad.cpu(), b.grad.cpu())
    before = sg.segment_rows_cuda.launches
    a = img.to(cuda).requires_grad_()
    grid_sample(a, grid.to(cuda)).sum().backward()
    assert sg.segment_rows_cuda.launches == before + 1
    for x, y in zip(res["cpu"], res[str(cuda)]):
        _close(y, x, 1e-4)
