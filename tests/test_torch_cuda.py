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
@pytest.mark.parametrize("radius", [4, 7, 3])
@pytest.mark.parametrize("pairs", [1, 2])
def test_corr_lookup_kernel_matches_plain(rng, cuda, dtype, tol, radius,
                                          pairs):
    """Forward and the accumulating backward (into zeroed buffers) on
    levels with odd widths, B = 1 and 2, RAFT's radius, the largest and
    RAFT-small's, with in-map, border, out-of-map and non-finite
    coordinates."""
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
def test_hybrid_lookup_kernel_on_the_sub_pyramid(rng, cuda, dtype, tol):
    """The hybrid path's levels 1..3: the kernel on the 3-level pyramid of
    `corr_pyramid_pooled(start_level=1)` at coords / 2 scales its level l
    by 2ˡ, so it reads pyramid level l + 1 at coords / 2ˡ⁺¹: against the
    plain version on the same sub-pyramid and against levels 1..3 of the
    plain lookup on the whole pyramid. Then `corr_lookup_hybrid` on the
    card against the CPU, forward and d fmap1, d fmap2 (float32)."""
    from pcfa_tpu_torch.ops.correlation import (corr_lookup_hybrid,
                                                corr_pyramid_pooled)

    # 16×24: the coarsest level is 2×3 (the plain lookup gives NaN on a
    # level one cell high or wide)
    f1, f2 = (_t(rng.standard_normal((2, 16, 24, 32))).to(cuda, dtype)
              for _ in range(2))
    coords = _t(rng.uniform(-3, 27, (2 * 16 * 24, 2))).to(cuda)
    with torch.no_grad():
        full = corr_pyramid_pooled(f1, f2, 4)
        rest = corr_pyramid_pooled(f1, f2, 4, start_level=1)
    assert [tuple(t.shape) for t in rest] == [tuple(t.shape)
                                              for t in full[1:]]
    got = cl.corr_window_fwd(list(rest), coords / 2, R)
    torch.cuda.synchronize()
    _close(got, cl.corr_window_plain(list(rest), coords / 2, R), tol)
    _close(got, cl.corr_window_plain(list(full), coords, R)[:, P * P:], tol)

    c4 = coords.reshape(2, 16, 24, 2)
    g = _t(rng.standard_normal((2, 16, 24, 4 * P * P)))
    res = []
    for dev in ("cpu", cuda):
        a, b = (t.detach().float().to(dev).requires_grad_() for t in (f1, f2))
        rest = corr_pyramid_pooled(a, b, 4, start_level=1)
        out = corr_lookup_hybrid(a, b, rest, c4.to(dev), R, block=100)
        (out * g.to(dev)).sum().backward()
        res.append([t.detach().cpu() for t in (out, a.grad, b.grad)])
    for x, y in zip(*res[::-1]):
        _close(x, y, 1e-4)


@pytest.mark.cuda
def test_gma_card_matches_cpu(cuda):
    """A random GMA (flow-head conv2 damped ×0.01, gamma 0.5), 128×128, 3
    iterations, float32: the card (lookup and small-conv kernels) against
    the CPU (plain versions), flow_up and the input gradients of
    Σ flow_up·g. Tolerances as `chip_smoke.card_vs_cpu`: flows rtol/atol
    1e-3; gradients rel L2 1e-2 and 99.5% of the elements at 1e-3 (float32
    rounding flips a few ReLU units of a random net on either device)."""
    import copy

    from pcfa_tpu_torch.ops import small_conv as sc
    from pcfa_tpu_torch.runtime import load_model

    module = load_model("GMA", init_random=True, seed=0, device="cpu",
                        iters=3).module
    with torch.no_grad():
        module.update_block.flow_head.conv2.weight.mul_(0.01)
        module.update_block.flow_head.conv2.bias.mul_(0.01)
        module.update_block.aggregator.gamma.fill_(0.5)
    gen = torch.Generator().manual_seed(0)
    i1, i2 = (torch.rand((2, 128, 128, 3), generator=gen) for _ in range(2))
    g = torch.randn((2, 128, 128, 2), generator=gen)
    res = {}
    launched = (cl.corr_window_fwd.launches, cl.corr_window_bwd.launches,
                sc.small_conv_fwd.launches, sc.small_conv_dx.launches)
    for dev, model in (("cpu", module),
                       ("cuda", copy.deepcopy(module).to(cuda))):
        a, b = (t.to(dev).detach().requires_grad_() for t in (i1, i2))
        _, up = model(a, b)
        (up * g.to(dev)).sum().backward()
        res[dev] = [t.detach().cpu().double() for t in (up, a.grad, b.grad)]
    now = (cl.corr_window_fwd.launches, cl.corr_window_bwd.launches,
           sc.small_conv_fwd.launches, sc.small_conv_dx.launches)
    assert all(n > w for n, w in zip(now, launched))
    (up_c, *gc), (up_g, *gg) = res["cpu"], res["cuda"]
    assert torch.allclose(up_g, up_c, rtol=1e-3, atol=1e-3)
    for x, y in zip(gg, gc):
        assert float((x - y).norm() / y.norm()) <= 1e-2
        assert float(((x - y).abs() <= 1e-3 + 1e-3 * y.abs()).double()
                     .mean()) >= 0.995


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
    # SpyNet's five 7×7 stride-1 convs (B = 2 pairs) at 24×80, where the
    # plans cannot fill the card, with ReLU and without; its largest
    # staging (32 -> 64, the masked dx: one block per SM) at 192×640; the
    # last layer (16 -> 2) at 384×1280
    (2, 8, 24, 80, 32, 7, 1, "relu"),
    (2, 32, 24, 80, 64, 7, 1, "relu"),
    (2, 64, 24, 80, 32, 7, 1, "relu"),
    (2, 32, 24, 80, 16, 7, 1, "relu"),
    (2, 16, 24, 80, 2, 7, 1, None),
    (2, 8, 12, 40, 32, 7, 1, None),
    (2, 64, 12, 40, 32, 7, 1, None),
    (2, 32, 192, 640, 64, 7, 1, "relu"),
    (2, 16, 384, 1280, 2, 7, 1, None),
    # FlowNet2's at 384×1280 (B = 1): FlowNetC's and FlowNetS's conv2 (k5
    # stride 2), FlowNetS's conv1 (C_in 12), FlowNetSD's conv0 (6) and
    # Fusion's conv0 (11) with the leaky epilogue; Fusion's inter_conv1
    # (162 -> 32) and inter_conv0 (82 -> 16), a flow prediction (128 ->
    # 2); the combined deconv weights (2 -> 8, 128 -> 128 leaky, 162 ->
    # 64 leaky), as 3×3 stride-1 convs
    (1, 64, 192, 640, 128, 5, 2, "leaky"),
    (1, 12, 384, 1280, 64, 7, 2, "leaky"),
    (1, 6, 384, 1280, 64, 3, 1, "leaky"),
    (1, 11, 384, 1280, 64, 3, 1, "leaky"),
    (1, 162, 192, 640, 32, 3, 1, None),
    (1, 82, 384, 1280, 16, 3, 1, None),
    (1, 128, 96, 320, 2, 3, 1, None),
    (1, 2, 48, 160, 8, 3, 1, None),
    (1, 128, 96, 320, 128, 3, 1, "leaky"),
    (1, 162, 192, 640, 64, 3, 1, "leaky"),
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


def _warp_state(rng, shape, zeros, dtype, coords=None):
    """The packed sampler's saved forward state for an image of `shape` in
    `dtype` and a float32 cotangent (what `pwc_warp`'s promoted output
    sends back), as `warp_bwd`'s first seven arguments, on the CPU:
    2·(H+2)·(W+1) samples at `coords` (B, Hg, Wg, 2) pixel positions
    (default: uniform over the image and a pixel beyond each edge)."""
    from pcfa_tpu_torch.ops import warp

    B, H, W, C = shape
    img = _t(rng.standard_normal(shape)).to(dtype)
    if coords is None:
        coords = rng.uniform(-1.5, 0.5, (B, H + 2, W + 1, 2)) \
            + rng.uniform(0, 1, (B, H + 2, W + 1, 2)) * (W + 1, H + 1)
    ix, iy = _t(coords[..., 0]), _t(coords[..., 1])
    idx, w4, mask4, a, b = warp._corner_weights(shape, ix, iy, zeros)
    win = warp._pack_windows(img)[idx].reshape(-1, 4, C)
    g = _t(rng.standard_normal((*ix.shape, C)))
    return [g, win, idx, w4, mask4, a, b]


def _close_nan(got, ref, tol):
    """`_close` where NaNs must sit at the same places."""
    got, ref = got.float().cpu(), ref.float().cpu()
    assert torch.equal(got.isnan(), ref.isnan())
    _close(got.nan_to_num(nan=0.0), ref.nan_to_num(nan=0.0), tol)


def _warp_bwd_check(state, shape, dtype, need=(True, True)):
    """The kernel on the card against the plain version in float64 on the
    CPU. d img: float32 sums in the atomics' varying order, up to 7,680
    terms in one cell (1e-4 of the largest value); a bf16 image's gradient
    is rounded once to bf16 (one bf16 ulp, ≤ 2⁻⁷ of a value: 1e-2). d ix,
    d iy: float32 dots of at most 128 products (1e-5). Returns the
    kernel's results."""
    from pcfa_tpu_torch.ops import segsum as sg

    ref = sg.warp_bwd_plain(*[t.double() if t is not None
                              and t.is_floating_point() else t
                              for t in state], shape, torch.float64, *need)
    before = sg.warp_bwd_cuda.launches
    got = sg.warp_bwd(*[None if t is None else t.to("cuda") for t in state],
                      shape, dtype, *need)
    torch.cuda.synchronize()
    assert sg.warp_bwd_cuda.launches == before + 1
    for i, (x, y) in enumerate(zip(got, ref)):
        if y is None:
            assert x is None
            continue
        assert x.shape == y.shape and x.is_cuda
        assert x.dtype == (dtype if i == 0 else torch.float32)
        _close_nan(x, y, 1e-5 if i else 1e-2 if dtype == torch.bfloat16
                   else 1e-4)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 32, 64, 96, 128])
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_warp_bwd_kernel_matches_plain(rng, cuda, mode, c, dtype):
    """d img, d ix, d iy at B = 2 for C = 3 (FlowNet2's images) and
    PWCNet's 32–128 channels, float32 and bf16 images."""
    shape = (2, 24, 40, c)
    state = _warp_state(rng, shape, mode == "zeros", dtype)
    _warp_bwd_check(state, shape, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["one_pixel_wide", "one_cell", "nan_far",
                                  "img_only", "grid_only", "odd_c"])
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_warp_bwd_kernel_edge_cases(rng, cuda, mode, case, dtype):
    """A one-pixel-wide image; every sample on one cell (PWCNet's level 3
    at 384×1280: 7,680 samples of 64 channels, a 7,680-way collision);
    NaN and ±1e30 coordinates; only d img or only the grid's gradient
    asked for; C = 17 (one channel per lane, groups of 4)."""
    shape = {"one_pixel_wide": (2, 7, 1, 32), "one_cell": (1, 48, 160, 64),
             "odd_c": (2, 9, 11, 17)}.get(case, (2, 12, 20, 32))
    B, H, W, C = shape
    coords = None
    if case == "one_cell":
        coords = np.broadcast_to((77.25, 20.5), (B, H, W, 2)).copy()
    elif case == "nan_far":
        coords = rng.uniform(-2, 22, (B, H, W, 2))
        coords[0, 0, :5] = [(np.nan, 1.0), (2.0, np.nan), (1e30, 1.0),
                            (-1e30, 2.0), (1.5, 1e30)]
        coords[1, 3, :4] = [(-1e30, -1e30), (W - 1.0, H - 1.0), (0.0, 0.0),
                            (np.nan, np.nan)]
    need = {"img_only": (True, False), "grid_only": (False, True)}.get(
        case, (True, True))
    state = _warp_state(rng, shape, mode == "zeros", dtype, coords)
    _warp_bwd_check(state, shape, dtype, need)


@pytest.mark.cuda
def test_warp_bwd_kernel_refuses_what_it_does_not_take(rng, cuda):
    from pcfa_tpu_torch.ops import segsum as sg

    shape = (1, 4, 5, 8)
    state = [None if t is None else t.to(cuda)
             for t in _warp_state(rng, shape, True, torch.float32)]
    with pytest.raises(TypeError):
        sg.warp_bwd(*state[:1], state[1].double(), *state[2:], shape,
                    torch.float64)
    with pytest.raises(TypeError):
        sg.warp_bwd(state[0].double(), *state[1:], shape, torch.float32)
    with pytest.raises(ValueError):
        sg.warp_bwd(*state[:2], state[2].int(), *state[3:], shape,
                    torch.float32)
    with pytest.raises(ValueError):
        sg.warp_bwd(*state[:2], state[2].cpu(), *state[3:], shape,
                    torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_sample_autograd_on_card(rng, cuda, dtype):
    """The packed sampler on the card against the same sampler on the
    CPU (the plain backward): one launch of the backward kernel per
    backward, and at most three device launches in the sampler's
    backward (the gradient's zero fill, the kernel, the cast of a bf16
    image's gradient)."""
    from torch.profiler import ProfilerActivity, profile

    from pcfa_tpu_torch.ops import segsum as sg
    from pcfa_tpu_torch.ops.warp import _PackedBilinear, grid_sample

    img = _t(rng.standard_normal((2, 24, 80, 32))).to(dtype)
    grid = _t(rng.uniform(-1.2, 1.2, (2, 24, 80, 2)))
    g = _t(rng.standard_normal((2, 24, 80, 32)))
    res = {}
    for dev in ("cpu", cuda):
        a = img.to(dev).detach().requires_grad_()
        b = grid.to(dev).detach().requires_grad_()
        (grid_sample(a, b) * g.to(dev)).sum().backward()
        res[str(dev)] = (a.grad.cpu(), b.grad.cpu())
    before = sg.warp_bwd_cuda.launches
    a = img.to(cuda).requires_grad_()
    grid_sample(a, grid.to(cuda)).sum().backward()
    assert sg.warp_bwd_cuda.launches == before + 1
    for i, (x, y) in enumerate(zip(res["cpu"], res[str(cuda)])):
        _close(y, x, 1e-2 if i == 0 and dtype == torch.bfloat16 else 1e-4)

    a = img.to(cuda).requires_grad_()
    ix, iy = (_t(rng.uniform(-2, 81, (2, 24, 80))).to(cuda).requires_grad_()
              for _ in range(2))
    out = _PackedBilinear.apply(a, ix, iy, True)
    gc = g.to(cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(out, (a, ix, iy), gc)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    assert 1 <= launches <= (3 if dtype == torch.bfloat16 else 2), \
        launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spynet_warp_on_card(rng, cuda, dtype):
    """SpyNet's warp (3 channels, zero padding, align_corners=False, the
    grid clipped to [−1, 1]) at its six level sizes for 384×1280, B = 2,
    flows large enough that many samples reach the zero border: one
    backward kernel launch per warp, and the card's d img and d flow
    against the CPU's (the plain backward). d img: float32 atomics in
    varying order (1e-4 of the largest value), one bf16 rounding of a
    bf16 image's gradient (1e-2); d flow 1e-4."""
    from pcfa_tpu_torch.models.spynet import spynet_warp
    from pcfa_tpu_torch.ops import segsum as sg

    for i in range(5, -1, -1):
        h, w = 384 >> i, 1280 >> i
        img = _t(rng.standard_normal((2, h, w, 3))).to(dtype)
        flow = _t(rng.standard_normal((2, h, w, 2)) * (0.05 * w))
        g = _t(rng.standard_normal((2, h, w, 3)))
        res = []
        for dev in ("cpu", cuda):
            a = img.to(dev).detach().requires_grad_()
            f = flow.to(dev).detach().requires_grad_()
            before = sg.warp_bwd_cuda.launches
            (spynet_warp(a, f) * g.to(dev)).sum().backward()
            torch.cuda.synchronize()
            assert sg.warp_bwd_cuda.launches == before + (dev != "cpu")
            res.append((a.grad.cpu(), f.grad.cpu()))
        (da_c, df_c), (da_g, df_g) = res
        assert da_g.dtype == dtype
        _close(da_g, da_c, 1e-2 if dtype == torch.bfloat16 else 1e-4)
        _close(df_g, df_c, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["RAFT-small", "SpyNet"])
def test_small_nets_card_match_cpu(cuda, name):
    """A random RAFT-small (flow-head conv2 damped ×0.01, 3 iterations)
    and SpyNet (6 levels), 128×128, 2 pairs, float32: the card (lookup at
    radius 3; SpyNet's 7×7 convs and zero-padded warps) against the CPU,
    the flow and the input gradients of Σ flow·g, as
    `test_gma_card_matches_cpu` holds GMA. A random SpyNet's float32
    input gradients differ from its float64 ones by 1e-3 to 3e-3 of their
    norm on the CPU alone (the CPU's float32 convolutions set which), so
    its gradients are held as
    `chip_smoke.check_against_f64` holds them: the card's relative L2
    error to the CPU's float64 gradient at most twice the CPU float32's,
    and within 1e-2 of the CPU float32's."""
    import copy

    from pcfa_tpu_torch.ops import segsum as sg
    from pcfa_tpu_torch.runtime import load_model

    kw = {"iters": 3} if name == "RAFT-small" else {}
    module = load_model(name, init_random=True, seed=0, device="cpu",
                        **kw).module
    if name == "RAFT-small":
        with torch.no_grad():
            module.update_block.flow_head.conv2.weight.mul_(0.01)
            module.update_block.flow_head.conv2.bias.mul_(0.01)
        counters = (cl.corr_window_fwd, cl.corr_window_bwd)
    else:
        counters = (sc.small_conv_fwd, sc.small_conv_dx, sg.warp_bwd_cuda)
    gen = torch.Generator().manual_seed(0)
    i1, i2 = (torch.rand((2, 128, 128, 3), generator=gen) for _ in range(2))
    g = torch.randn((2, 128, 128, 2), generator=gen)
    res = {}
    launched = [c.launches for c in counters]
    runs = (("cpu", module, torch.float32),
            ("cuda", copy.deepcopy(module).to(cuda), torch.float32),
            ("f64", copy.deepcopy(module).double(), torch.float64))
    for key, model, dt in runs:
        dev = cuda if key == "cuda" else "cpu"
        a, b = (t.to(dev, dt).detach().requires_grad_() for t in (i1, i2))
        up = model(a, b)
        up = up[-1] if isinstance(up, tuple) else up
        (up * g.to(dev, dt)).sum().backward()
        res[key] = [t.detach().cpu().double() for t in (up, a.grad, b.grad)]
    assert all(c.launches > n for c, n in zip(counters, launched))
    (up_c, *gc), (up_g, *gg), (_, *gt) = res["cpu"], res["cuda"], res["f64"]
    assert torch.allclose(up_g, up_c, rtol=1e-3, atol=1e-3)
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    for x, y, t in zip(gg, gc, gt):
        assert rel(x, y) <= 1e-2
        if name == "SpyNet":
            assert rel(x, t) <= max(2 * rel(y, t), 1e-6)
        else:
            assert float(((x - y).abs() <= 1e-3 + 1e-3 * y.abs()).double()
                         .mean()) >= 0.995


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", [
    # (C_in, C_out, H, W, bias, act): a flow upsampler (2 -> 2, the
    # combined 2 -> 8) with and without bias; Fusion's deconv1 and deconv0
    (2, 2, 48, 160, True, None),
    (2, 2, 6, 20, False, None),
    (128, 32, 96, 320, True, "leaky"),
    (162, 16, 192, 640, True, "leaky"),
])
def test_flownet2_deconv_on_card(rng, cuda, dtype, tol, case):
    """FlowNet2's transposed convs as one 3×3 small-conv launch with the
    combined weight and `pixel_shuffle`: the output against
    `F.conv_transpose2d` (+ leaky) in float32 on the same inputs, and the
    input gradient (one dx launch) against the plain one."""
    import torch.nn.functional as F

    from pcfa_tpu_torch.models.flownet2 import Deconv

    c_in, c_out, H, W, bias, act = case
    m = Deconv(c_in, c_out, bias=bias, act=act)
    with torch.no_grad():
        m.weight.copy_(_t(rng.standard_normal(m.weight.shape)
                          / np.sqrt(16 * c_in)))
        if bias:
            m.bias.copy_(_t(rng.standard_normal(c_out)))
    m = m.requires_grad_(False).to(cuda, dtype)
    x = _t(rng.standard_normal((1, c_in, H, W))).to(cuda, dtype)
    g = _t(rng.standard_normal((1, c_out, 2 * H, 2 * W))).to(cuda, dtype)
    f, d = sc.small_conv_fwd.launches, sc.small_conv_dx.launches
    xg = x.detach().requires_grad_()
    out = m(xg)
    out.backward(g)
    torch.cuda.synchronize()
    assert (sc.small_conv_fwd.launches, sc.small_conv_dx.launches) == (
        f + 1, d + 1)
    xf = x.float().requires_grad_()
    ref = F.conv_transpose2d(xf, m.weight.float(), None if m.bias is None
                             else m.bias.float(), 2, 1)
    if act == "leaky":
        ref = F.leaky_relu(ref, 0.1)
    ref.backward(g.float())
    assert out.dtype == dtype and out.shape == ref.shape
    _close(out.detach(), ref.detach(), tol)
    _close(xg.grad, xf.grad, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resample2d_on_card(rng, cuda, dtype):
    """FlowNet2's warp (3 channels, per-corner border clamp) at 384×1280,
    B = 1, with a flow large enough that many samples leave the image:
    one backward kernel launch, and the card's output, d img and d flow
    against the CPU's (the plain backward): output and d flow 1e-4
    (float32 sums), d img 1e-4, or one bf16 rounding (1e-2)."""
    from pcfa_tpu_torch.ops import segsum as sg
    from pcfa_tpu_torch.ops.warp import resample2d

    img = _t(rng.standard_normal((1, 384, 1280, 3))).to(dtype)
    flow = _t(rng.standard_normal((1, 384, 1280, 2)) * 40.0)
    g = _t(rng.standard_normal((1, 384, 1280, 3)))
    res = []
    for dev in ("cpu", cuda):
        a = img.to(dev).detach().requires_grad_()
        f = flow.to(dev).detach().requires_grad_()
        before = sg.warp_bwd_cuda.launches
        out = resample2d(a, f)
        (out * g.to(dev)).sum().backward()
        torch.cuda.synchronize()
        assert sg.warp_bwd_cuda.launches == before + (dev != "cpu")
        assert out.dtype == torch.float32
        res.append((out.detach().cpu(), a.grad.cpu(), f.grad.cpu()))
    (o_c, da_c, df_c), (o_g, da_g, df_g) = res
    assert da_g.dtype == dtype
    _close(o_g, o_c, 1e-4)
    _close(da_g, da_c, 1e-2 if dtype == torch.bfloat16 else 1e-4)
    _close(df_g, df_c, 1e-4)


def _card_cpu_f64(module, inputs, g, cuda, jitter=3):
    """flow and input gradients of Σ flow·g (as float64 CPU tensors): CPU
    float32, card float32, CPU float64, and `jitter` more CPU float32 runs
    at inputs scaled by 1 + 2e-7·N(0, 1) (about one float32 ulp)."""
    import copy

    gen = torch.Generator().manual_seed(100)
    runs = [("cpu", module, torch.float32, inputs),
            ("cuda", copy.deepcopy(module).to(cuda), torch.float32, inputs),
            ("f64", copy.deepcopy(module).double(), torch.float64, inputs)]
    runs += [("cpu", module, torch.float32, [
        t * (1 + 2e-7 * torch.randn(t.shape, generator=gen))
        for t in inputs]) for _ in range(jitter)]
    res = []
    for key, model, dt, ins in runs:
        dev = cuda if key == "cuda" else "cpu"
        a, b = (t.to(dev, dt).detach().requires_grad_() for t in ins)
        up = model(a, b)
        (up * g.to(dev, dt)).sum().backward()
        res.append([t.detach().cpu().double() for t in (up, a.grad, b.grad)])
    return res[0], res[1], res[2], res[3:]


@pytest.mark.cuda
def test_flownet2_card_matches_cpu(cuda):
    """A random FlowNet2 (seed 0), 128×128, one pair, float32: the card
    (small conv, patch correlation, border warps) against the CPU, the
    flow at rtol/atol 1e-3, and the input gradients of Σ flow·g against
    the CPU's float64 ones. A random FlowNet2's float32 input gradients
    lie anywhere from 2e-4 to 8e-3 (rel L2) from its float64 ones on the
    CPU alone as its inputs move by one float32 ulp (the warps' floors and
    the leaky kinks amplify rounding), so the card's error is held to
    twice the largest of four CPU float32 runs' (these inputs and three
    jittered by ~1 ulp), as `chip_smoke.check_against_f64` holds it."""
    from pcfa_tpu_torch.ops import local_corr as lc
    from pcfa_tpu_torch.ops import segsum as sg
    from pcfa_tpu_torch.runtime import load_model

    module = load_model("FlowNet2", init_random=True, seed=0,
                        device="cpu").module
    gen = torch.Generator().manual_seed(0)
    inputs = [torch.rand((1, 128, 128, 3), generator=gen) for _ in range(2)]
    g = torch.randn((1, 128, 128, 2), generator=gen)
    counters = (sc.small_conv_fwd, sc.small_conv_dx, lc.local_corr_fwd,
                lc.local_corr_bwd, sg.warp_bwd_cuda)
    launched = [c.launches for c in counters]
    (up_c, *gc), (up_g, *gg), (_, *gt), jittered = _card_cpu_f64(
        module, inputs, g, cuda)
    assert [c.launches - n for c, n in zip(counters, launched)] == [
        41, 41, 1, 1, 4]
    assert torch.allclose(up_g, up_c, rtol=1e-3, atol=1e-3)
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    for i, (x, t) in enumerate(zip(gg, gt)):
        band = max(rel(r[1 + i], t) for r in ([up_c, *gc], *jittered))
        assert rel(x, t) <= 2 * band, (rel(x, t), band)


@pytest.mark.cuda
def test_fgsm_and_universal_on_card(cuda):
    """I-FGSM (2 steps) and the universal attack (2 batches × 1 step ×
    max_iter 1, the state carried) on a random SpyNet at 128×128 with 2
    pairs, on the card and on the CPU: both launch the small conv and the
    warp's backward on the card, and the history grows across the
    batches. I-FGSM's metrics at every step and the universal attack's
    after its first batch agree within 1e-3 relative (card against CPU
    on an H100 host: 1.6e-4 at most). Later L-BFGS iterations are not
    compared: there a curvature pair whose s·y lies near the push
    threshold is kept on one device and dropped on the other, and the
    CPU's float32 against its float64 then differ by a quarter."""
    from pcfa_tpu_torch.attack import fgsm, universal
    from pcfa_tpu_torch.ops import segsum as sg
    from pcfa_tpu_torch.runtime import load_model

    module = load_model("SpyNet", init_random=True, seed=0,
                        device="cpu").module
    gen = torch.Generator().manual_seed(1)
    imgs = [torch.rand((2, 128, 128, 3), generator=gen) for _ in range(4)]
    tgt = torch.zeros((2, 128, 128, 2))
    fcfg = fgsm.FGSMConfig(steps=2, epsilon=0.001)
    ucfg = universal.UniversalConfig(steps=1, max_iter=1, history_size=5,
                                     lbfgs_direction="compact")
    res = {}
    counters = (sc.small_conv_fwd, sc.small_conv_dx, sg.warp_bwd_cuda)
    for dev in ("cpu", cuda):
        net = module.to(dev)
        launched = [c.launches for c in counters]
        f = fgsm.fgsm_attack(net, imgs[0], imgs[1], tgt, fcfg, device=dev)
        state = universal.universal_init((128, 128, 3), ucfg, device=dev)
        ums, counts = [], []
        for i in (0, 2):
            state, m, _, _ = universal.universal_batch_attack(
                net, imgs[i], imgs[i + 1], tgt, state, ucfg)
            ums.append(m)
            counts.append(int(state.count[0]))
        if dev != "cpu":
            assert all(c.launches > n for c, n in zip(counters, launched))
        assert counts[1] > counts[0]
        for m in (f.metrics, *ums):
            assert all(torch.isfinite(v).all() for v in m)
        res[str(dev)] = (f.metrics, ums[0])
    errs = {}
    for attack, got, ref in zip(("fgsm", "universal"), res[str(cuda)],
                                res["cpu"]):
        for name, a, b in zip(got._fields, got, ref):
            a, b = a.cpu().double(), b.double()
            errs[f"{attack} {name}"] = float(((a - b).abs() / b.abs()).max())
    assert max(errs.values()) <= 1e-3, errs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_clip01_on_card(cuda, dtype):
    """The box clip on CUDA tensors, its bounds given as CPU scalars:
    values in the tensor's dtype on the card, derivative ½ exactly on 0
    and on 1, 1 inside and 0 outside."""
    from pcfa_tpu_torch.attack.boxconstraint import clip01

    x = torch.tensor([-0.5, 0.0, 0.25, 1.0, 1.5], device=cuda,
                     dtype=dtype).requires_grad_()
    y = clip01(x)
    y.sum().backward()
    assert y.device == x.device and y.dtype == dtype
    assert y.tolist() == [0.0, 0.0, 0.25, 1.0, 1.0]
    assert x.grad.tolist() == [0.0, 0.5, 1.0, 0.5, 0.0]
