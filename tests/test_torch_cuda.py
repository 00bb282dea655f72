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


def _lookup_case(rng, dev, dtype, pairs, shapes):
    """Levels for `pairs`·4·8 queries and coords that cover in-map,
    border, out-of-map, far-off and non-finite points. Returns (levels,
    coords, keep): `keep` marks the queries the plain version (whose
    `grid_sample` gives NaN for |x| ~ 1e30 on CUDA) can be compared on."""
    n = pairs * 4 * 8
    levels = [_t(rng.standard_normal((n, h, w))).to(dev, dtype)
              for h, w in shapes]
    c = _t(rng.uniform(-8, shapes[0][1] + 8, (n, 2))).to(dev)
    c[0] = torch.tensor([0.0, 0.0])
    c[1] = torch.tensor([shapes[0][1] - 1.0, shapes[0][0] - 1.0])
    c[2] = torch.tensor([-40.0, 100.0])
    # coords beyond any map, and non-finite ones, must not index out of
    # bounds; the kernel returns zeros for the far ones
    c[3] = torch.tensor([1e30, -1e30])
    c[4] = torch.tensor([-3e9, 7.0])
    c[5] = float("nan")
    c[6] = float("inf")
    keep = torch.isfinite(c).all(1) & (c.abs() < 1e6).all(1)
    return levels, c, keep


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("radius", [4, 7])
@pytest.mark.parametrize("pairs", [1, 2])
def test_corr_lookup_kernel_matches_plain(rng, cuda, dtype, tol, radius,
                                          pairs):
    """Forward and the accumulating backward (into zeroed buffers) on
    levels with odd widths, B = 1 and 2, RAFT's radius and the largest,
    with in-map, border, out-of-map and non-finite coordinates."""
    shapes = [(24, 37), (12, 19), (6, 9), (3, 5)]
    levels, c, keep = _lookup_case(rng, cuda, dtype, pairs, shapes)
    n, p = c.shape[0], 2 * radius + 1
    before = cl.corr_window_fwd.launches
    out = cl.corr_window_fwd(levels, c, radius)
    torch.cuda.synchronize()
    assert cl.corr_window_fwd.launches == before + 1
    assert out.shape == (n, 4 * p * p) and out.dtype == dtype
    _close(out[keep], cl.corr_window_plain(levels, c, radius)[keep], tol)
    assert torch.count_nonzero(out[3:5]) == 0

    g = _t(rng.standard_normal(tuple(out.shape))).to(cuda, dtype)
    g[~keep] = 0
    bufs = [torch.zeros_like(t) for t in levels]
    before = cl.corr_window_bwd.launches
    got = cl.corr_window_bwd(g, bufs, c, radius)
    torch.cuda.synchronize()
    assert got is bufs and cl.corr_window_bwd.launches == before + 1
    ref = cl.corr_window_bwd_plain(g, levels, c, radius)
    for a, b in zip(got, ref):
        _close(a[keep], b[keep], tol)
        assert torch.count_nonzero(a[~keep]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_corr_lookup_kernel_accumulates_twelve_launches(rng, cuda, dtype,
                                                        tol):
    """12 backward launches with different coords into one set of buffers
    against 12 plain backwards summed in the maps' dtype (as autograd
    summed them), on the KITTI pyramid's level sizes."""
    n = 2 * 6 * 16
    shapes = [(47, 156), (23, 78), (11, 39), (5, 19)]
    got = [torch.zeros((n, h, w), device=cuda, dtype=dtype)
           for h, w in shapes]
    ref = [torch.zeros_like(t) for t in got]
    c0 = _t(rng.uniform(-8, 164, (n, 2)))
    for _ in range(12):
        c = (c0 + _t(rng.standard_normal((n, 2)) * 3.0)).to(cuda)
        g = _t(rng.standard_normal((n, 4 * P * P))).to(cuda, dtype)
        cl.corr_window_bwd(g, got, c, R)
        cl.corr_window_bwd_acc_plain(g, ref, c, R)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        _close(a, b, tol)


def _tent_window(levels, coords, radius):
    """Float64 window lookup by tent weights (as `corr_lookup_mm_rf`):
    out[a·P+b] = Σ_jk max(0, 1−|y+b−r−j|)·max(0, 1−|x+a−r−k|)·map[j, k].
    Unlike `grid_sample`, defined on a 1×1 map."""
    p = 2 * radius + 1
    off = torch.arange(p, dtype=torch.float64, device=coords.device) - radius
    out = []
    for i, lv in enumerate(levels):
        h, w = lv.shape[1:]
        c = coords.double() / 2 ** i
        sx = c[:, 0:1, None] + off[None, :, None]
        sy = c[:, 1:2, None] + off[None, :, None]
        wx = (1 - (sx - torch.arange(w, device=c.device)).abs()).clamp(min=0)
        wy = (1 - (sy - torch.arange(h, device=c.device)).abs()).clamp(min=0)
        out.append(torch.einsum("nak,nbj,njk->nab", wx, wy, lv.double())
                   .reshape(-1, p * p))
    return torch.cat(out, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_corr_lookup_kernel_one_by_one_level(rng, cuda, dtype, tol):
    """A pyramid down to 1×1 (inputs below 128 px): forward and backward
    against the float64 tent-weight lookup and its autograd gradient (the
    plain version's `grid_sample` is undefined on a 1×1 map)."""
    shapes = [(8, 11), (4, 5), (2, 2), (1, 1)]
    n = 2 * 8 * 11
    levels = [_t(rng.standard_normal((n, h, w))).to(cuda, dtype)
              for h, w in shapes]
    c = _t(rng.uniform(-3, 14, (n, 2))).to(cuda)
    c[:8] = c.new_tensor(rng.uniform(-1.5, 1.5, (8, 2)))  # near the 1×1 cell
    out = cl.corr_window_fwd(levels, c, R)
    ref = [t.double().requires_grad_() for t in levels]
    want = _tent_window(ref, c, R)
    _close(out, want, tol)
    g = _t(rng.standard_normal(tuple(out.shape))).to(cuda, dtype)
    got = cl.corr_window_bwd(g, [torch.zeros_like(t) for t in levels], c, R)
    torch.cuda.synchronize()
    want.backward(g.double())
    for a, b in zip(got, ref):
        _close(a, b.grad, tol)
    assert float(got[3].abs().max()) > 0


@pytest.mark.cuda
def test_corr_lookup_autograd_on_card(rng, cuda):
    """The dispatch runs the kernels on CUDA tensors, in both directions:
    on a plain list of levels (each lookup fills its own buffers) and on
    `corr_pyramid_pooled`'s pyramid (three lookups add into one buffer
    per level), against plain autograd."""
    from pcfa_tpu_torch.ops.correlation import (corr_lookup_window,
                                                corr_pyramid_pooled)

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

    f1, f2 = (_t(rng.standard_normal((2, h, w, 16))).to(cuda)
              .requires_grad_() for h, w in [(3, 4), (16, 24)])
    cs = [_t(rng.uniform(-2, 26, (2, 3, 4, 2))).to(cuda) for _ in range(3)]
    grads = []
    for lookup in (corr_lookup_window, None):
        f, b = cl.corr_window_fwd.launches, cl.corr_window_bwd.launches
        pyr = corr_pyramid_pooled(f1, f2, 4)
        if lookup is None:  # plain autograd through the plain version
            lookup = lambda p, c, r: cl.corr_window_plain(  # noqa: E731
                p, c.reshape(-1, 2), r)
            launched = (f, b)
        else:
            launched = (f + 3, b + 3)
        sum(lookup(pyr, c, R).square().sum() for c in cs).backward()
        assert (cl.corr_window_fwd.launches,
                cl.corr_window_bwd.launches) == launched
        grads.append([f1.grad, f2.grad])
        f1.grad = f2.grad = None
    for a, r in zip(*grads):
        _close(a, r, 1e-4)


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
    # the tensor-core tiling's edges: C_in not a multiple of 16, C_out
    # not a multiple of 8, M tiles cut by odd H and W, k5 in both strides,
    # maps smaller than one tile, N = 96 split across blocks
    (1, 16, 33, 47, 20, 5, 1, "relu"),
    (2, 32, 29, 45, 7, 5, 2, "leaky"),
    (1, 5, 6, 20, 96, 3, 1, "leaky"),
    (1, 64, 6, 20, 96, 3, 2, "leaky"),    # conv4a's 64 -> 96
    (2, 64, 48, 160, 96, 3, 2, "leaky"),  # conv4a at 384x1280
    (1, 20, 19, 23, 3, 7, 2, "relu"),
    # RAFT's layer1 and stem at the KITTI shape, batch cut to 1
    (1, 64, 188, 624, 64, 3, 1, None),
    (1, 3, 376, 1248, 64, 7, 2, None),
])
def test_small_conv_kernel_matches_plain(rng, cuda, dtype, tol, case):
    """Forward (bias, act) and dx (with the act derivative fused, from the
    kernel's own output) against the plain versions in float32."""
    B, C_in, H, W, C_out, k, s, act = case
    x = _t(rng.standard_normal((B, C_in, H, W))).to(cuda, dtype)
    w = _t(rng.standard_normal((C_out, C_in, k, k)) / np.sqrt(C_in * k * k))
    w = w.to(cuda, dtype)
    b = _t(rng.standard_normal(C_out)).to(cuda, dtype)
    before = (sc.small_conv_fwd.launches, sc.small_conv_dx.launches)
    out = sc.small_conv_fwd(x, w, b, s, act)
    assert out.shape == (B, C_out, -(-H // s), -(-W // s))
    _close(out, sc.conv_plain(x.float(), w.float(), b.float(), s, act), tol)
    g = _t(rng.standard_normal(tuple(out.shape))).to(cuda, dtype)
    dx = sc.small_conv_dx(g, w, x.shape, s, out, act)
    torch.cuda.synchronize()
    assert dx.dtype == dtype
    _close(dx, sc.conv_dx_plain(g.float(), w.float(), x.shape, s,
                                out.float(), act), tol)
    assert (sc.small_conv_fwd.launches, sc.small_conv_dx.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_small_conv_dx_needs_the_forward_output(cuda):
    w = torch.ones((4, 3, 3, 3), device=cuda, dtype=torch.bfloat16)
    g = torch.ones((1, 4, 5, 5), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        sc.small_conv_dx(g, w, (1, 3, 5, 5), 1, None, "leaky")


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
    (1, 12, 40, 128, 9, 1),    # level 5
    (1, 24, 80, 96, 9, 1),     # level 4
    (2, 48, 160, 64, 9, 1),    # level 3, B = 2
    (1, 96, 320, 32, 9, 1),    # level 2
    (2, 7, 45, 33, 5, 1),      # odd sizes, ragged channel chunk
    (1, 9, 37, 12, 9, 1),      # W not a multiple of the tile, C % 8 != 0
    (1, 2, 3, 5, 9, 1),        # map smaller than the patch
    (1, 20, 40, 256, 21, 2),   # FlowNetC's patch and stride
    (1, 48, 160, 256, 21, 2),  # FlowNetC at 384×1280
])
def test_local_corr_kernel_matches_plain(rng, cuda, dtype, tol, case):
    """Forward and backward (df1, df2) against the plain versions, each
    kernel launched once; tolerances relative to the plain result's
    largest magnitude (bf16: one rounding of the float32 sum)."""
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
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("field,bad", [
    ("stage_bytes", lambda v: v // 32 * 16),   # halo rows past the buffer
    ("smem", lambda v: v // 32 * 16),          # tiles past the allocation
    ("gz", lambda v: v + 2),                   # an image that is not there
    ("gx", lambda v: 1),                       # columns left unwritten
    ("pitch", lambda v: v // 32 * 16),         # channels past a pixel
])
def test_local_corr_kernel_refuses_an_inconsistent_plan(rng, cuda, kind,
                                                        field, bad):
    """The C entry points check the plan's grid and shared-memory layout
    against what the kernels index, and refuse a plan that would run past
    them, instead of reading or writing out of bounds."""
    from pcfa_tpu_torch.ops import local_corr as lc

    shape, esz = (1, 24, 80, 96), 2
    f1, f2 = (_t(rng.standard_normal(shape)).to(cuda, torch.bfloat16)
              for _ in range(2))
    g = _t(rng.standard_normal(shape[:3] + (81,))).to(cuda, torch.bfloat16)
    plan = lc._plan(kind, *shape, 9, 1, esz)
    plan = plan._replace(**{field: bad(getattr(plan, field))})
    ints = [getattr(plan, f) for f in lc.PLAN_FIELDS]
    key = (kind, shape, 9, 1, esz)
    lc._plans[key] = (plan, (lc._I * len(ints))(*ints))
    try:
        with pytest.raises(RuntimeError, match="cudaError 1"):
            if kind == "fwd":
                lc.local_corr_fwd(f1, f2, 9, 1)
            else:
                lc.local_corr_bwd(g, f1, f2, 9, 1)
    finally:
        lc._plans.pop(key)
    torch.cuda.synchronize()


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
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_local_corr_cotangent_through_pwcnet_epilogue(rng, cuda, dtype, tol,
                                                      monkeypatch):
    """As on PWCNet's path (`models/pwcnet.py`, `_correlate`): the
    correlation's cotangent comes back through the leaky ReLU and the
    permute to NCHW and a concatenation. It reaches the backward kernel
    contiguous (no copy), and both map gradients match the plain ones."""
    from pcfa_tpu_torch.models.pwcnet import PWCDCNet
    from pcfa_tpu_torch.ops import local_corr as lc

    seen = []
    kernel = lc.local_corr_bwd

    def bwd(g, *args):
        seen.append(g.is_contiguous())
        return kernel(g, *args)

    bwd.launches = 0  # the kernel's wrapper counts on the patched name
    monkeypatch.setattr(lc, "local_corr_bwd", bwd)
    f1, f2 = (_t(rng.standard_normal((1, 24, 80, 96))).to(cuda, dtype)
              for _ in range(2))
    up = _t(rng.standard_normal((1, 2, 24, 80))).to(cuda, dtype)
    w = _t(rng.standard_normal((1, 81 + 96 + 2, 24, 80))).to(cuda, dtype)
    grads = []
    for corr in (lc.local_corr, lambda a, b, p, s: lc.local_corr_plain(
            a, b, p, s)):
        a, b = (t.detach().requires_grad_() for t in (f1, f2))
        monkeypatch.setattr("pcfa_tpu_torch.models.pwcnet.local_corr", corr)
        x = torch.cat([PWCDCNet._correlate(None, a, b),
                       a.permute(0, 3, 1, 2), up], dim=1)
        (x * w).sum().backward()
        grads.append((a.grad, b.grad))
    assert seen == [True]
    for got, ref in zip(*grads):
        _close(got, ref, tol)


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
