"""The port's kernels on the CPU (the RAFT slice's corr lookup and small
conv, PWCNet's patch correlation and segment row-sum): their plain
versions vs `pcfa_tpu` (the XLA ops, the Pallas kernels in interpret mode)
and the autograd wiring of each wrapper. The CUDA kernels themselves are
held against the plain versions on the card by `tests/test_torch_cuda.py`
and `chip_smoke.py`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcfa_tpu.ops import correlation as jcorr
from pcfa_tpu.ops.pallas.corr_lookup import corr_lookup_pallas
from pcfa_tpu_torch.ops import corr_lookup as cl
from pcfa_tpu_torch.ops import local_corr as lc
from pcfa_tpu_torch.ops import segsum as sg
from pcfa_tpu_torch.ops import small_conv as sc
from pcfa_tpu_torch.ops.correlation import corr_lookup, corr_lookup_window

R = 4
P = 2 * R + 1


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _lookup_inputs(rng, n_side=8, hw=(16, 24), c=16):
    """A 4-level pyramid for B·n_side² = 64 queries (JAX layout), and coords
    that cover in-map, integer, border and far out-of-map points."""
    f1 = rng.standard_normal((1, n_side, n_side, c)).astype(np.float32)
    f2 = rng.standard_normal((1, *hw, c)).astype(np.float32)
    pyr = [np.asarray(lv) for lv in jcorr.corr_pyramid_pooled(
        jnp.asarray(f1), jnp.asarray(f2), 4)]
    coords = rng.uniform(-6, hw[1] + 6, (1, n_side, n_side, 2))
    coords = coords.astype(np.float32)
    coords[0, 0, 0] = (0.0, 0.0)
    coords[0, 0, 1] = (hw[1] - 1.0, hw[0] - 1.0)
    coords[0, 0, 2] = (-40.0, 100.0)
    coords[0, 0, 3] = (5.0, 7.0)
    return pyr, coords


def _port_pyr(pyr, dtype=torch.float32, requires_grad=False):
    return [_t(lv[..., 0]).to(dtype).requires_grad_(requires_grad)
            for lv in pyr]


def test_lookup_plain_matches_mm_rf_and_pallas(rng):
    """Values and the cmap gradient against the JAX default lookup
    (`corr_lookup_mm_rf`) and the Pallas kernel in interpret mode. Both
    are float32 bilinear blends of the same map; 2e-5 / 1e-4 cover the
    different association of the two-tap sums."""
    pyr, coords = _lookup_inputs(rng)
    jp, jc = [jnp.asarray(lv) for lv in pyr], jnp.asarray(coords)
    ref_mm = np.asarray(jcorr.corr_lookup_mm_rf(jp, jc, R))
    ref_pl = np.asarray(corr_lookup_pallas(jp, jc, R, interpret=True))

    levels = _port_pyr(pyr, requires_grad=True)
    got = corr_lookup(levels, _t(coords), R)
    assert got.shape == (1, 8, 8, 4 * P * P)
    np.testing.assert_allclose(got.detach().numpy(), ref_mm, atol=2e-5)
    np.testing.assert_allclose(got.detach().numpy(), ref_pl, atol=2e-5)

    g = rng.standard_normal(ref_mm.shape).astype(np.float32)
    (got * _t(g)).sum().backward()
    for fn in (jcorr.corr_lookup_mm_rf,
               lambda p, c, r: corr_lookup_pallas(p, c, r, interpret=True)):
        jg = jax.grad(lambda p: jnp.sum(fn(p, jc, R) * g))(jp)
        for lv, ref in zip(levels, jg):
            np.testing.assert_allclose(lv.grad.numpy(),
                                       np.asarray(ref)[..., 0], atol=1e-4)


def test_lookup_plain_bf16_matches_mm_rf(rng):
    """bf16 maps: the port blends in float32 and rounds once; JAX's mm_rf
    rounds its bf16 partial products, so 2e-2 on O(1) values."""
    pyr, coords = _lookup_inputs(rng)
    jp = [jnp.asarray(lv, jnp.bfloat16) for lv in pyr]
    ref = np.asarray(jcorr.corr_lookup_mm_rf(jp, jnp.asarray(coords), R),
                     np.float32)
    got = corr_lookup(_port_pyr(pyr, torch.bfloat16), _t(coords), R)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2,
                               rtol=2e-2)


def test_lookup_first_offset_moves_x():
    """The reference's transposed window: per level, index a·(2r+1)+b
    samples at (x + a − r, y + b − r)."""
    H2, W2 = 12, 20
    cols = np.broadcast_to(np.arange(W2, dtype=np.float32), (H2, W2))
    rows = np.broadcast_to(np.arange(H2, dtype=np.float32)[:, None], (H2, W2))
    coords = torch.tensor([[9.0, 6.0]])
    for cmap, moved in ((cols, "x"), (rows, "y")):
        out = cl.corr_window_plain([_t(cmap)[None]], coords, R)[0]
        a, b = np.meshgrid(np.arange(P), np.arange(P), indexing="ij")
        want = (9.0 + a - R) if moved == "x" else (6.0 + b - R)
        np.testing.assert_allclose(out.numpy(), want.reshape(-1), atol=1e-6)


def test_lookup_out_of_map_is_zero(rng):
    pyr, _ = _lookup_inputs(rng)
    far = torch.tensor([[-1e4, 3.0], [5.0, 1e4], [1e9, -1e9]])
    levels = [lv[:3] for lv in _port_pyr(pyr)]
    out = cl.corr_window_plain(levels, far, R)
    assert torch.count_nonzero(out) == 0


def test_lookup_cpu_dispatch_is_plain_and_detaches_coords(rng):
    pyr, coords = _lookup_inputs(rng)
    levels = _port_pyr(pyr)
    c = _t(coords).requires_grad_(True)
    before = (cl.corr_window_fwd.launches, cl.corr_window_bwd.launches)
    out = corr_lookup_window(levels, c, R)
    assert not out.requires_grad
    np.testing.assert_array_equal(out.numpy(),
                                  corr_lookup(levels, _t(coords), R).numpy())
    assert (cl.corr_window_fwd.launches, cl.corr_window_bwd.launches) == before


def test_lookup_bwd_plain_is_autograd(rng):
    pyr, coords = _lookup_inputs(rng)
    levels = _port_pyr(pyr, requires_grad=True)
    c = _t(coords).reshape(-1, 2)
    g = _t(rng.standard_normal((64, 4 * P * P)))
    (cl.corr_window_plain(levels, c, R) * g).sum().backward()
    for got, lv in zip(cl.corr_window_bwd_plain(g, levels, c, R), levels):
        np.testing.assert_allclose(got.numpy(), lv.grad.numpy(), atol=1e-6)


def test_lookup_autograd_function_wiring(rng, monkeypatch):
    """`_CorrWindow` with its two kernels swapped for their plain versions
    (this checks the wrapper's autograd plumbing, not the kernels): maps get
    the plain gradient, coords none, and each kernel counts one launch."""
    pyr, coords = _lookup_inputs(rng)
    levels = _port_pyr(pyr, requires_grad=True)
    c = _t(coords).reshape(-1, 2)

    def fwd(lv, co, r):
        cl.corr_window_fwd.launches += 1
        return cl.corr_window_plain(lv, co, r)

    def bwd(g, lv, co, r):
        cl.corr_window_bwd.launches += 1
        return cl.corr_window_bwd_plain(g, lv, co, r)

    monkeypatch.setattr(cl, "corr_window_fwd", fwd)
    monkeypatch.setattr(cl, "corr_window_bwd", bwd)
    fwd.launches = bwd.launches = 0
    out = cl._CorrWindow.apply(c, R, *levels)
    g = _t(rng.standard_normal(tuple(out.shape)))
    (out * g).sum().backward()
    ref = cl.corr_window_bwd_plain(g, levels, c, R)
    for lv, r in zip(levels, ref):
        np.testing.assert_allclose(lv.grad.numpy(), r.numpy(), atol=1e-6)
    assert (fwd.launches, bwd.launches) == (1, 1)


# ---------------------------------------------------------- small conv ---

def _pallas_interpret(monkeypatch):
    """Run `small_conv2d`'s Pallas forward in interpret mode on the CPU, as
    tests/test_pallas_kernels.py does."""
    import pcfa_tpu.ops.pallas.small_conv as m

    orig = m._forward
    monkeypatch.setattr(
        m, "_forward",
        lambda x, k, b, act, interpret=True, plan=None, stride=1: orig(
            x, k, b, act, interpret=True, stride=stride))
    return m


@pytest.mark.parametrize("case", [
    # (B, C_in, H, W, C_out, k, stride, act)
    (1, 3, 16, 40, 16, 7, 2, "relu"),     # RAFT stem class
    (1, 16, 12, 36, 16, 3, 1, None),      # RAFT layer1 class
    (1, 16, 12, 36, 16, 3, 1, "leaky"),
    (1, 3, 9, 23, 8, 7, 2, None),         # odd H/W under stride 2
    (2, 5, 11, 13, 6, 3, 1, "relu"),      # odd H/W, stride 1
])
def test_conv_plain_matches_small_conv2d(rng, monkeypatch, case):
    """Values and dx against `small_conv2d` (Pallas interpret forward and
    its custom VJP). float32 sums of ≤ 147 products: 2e-5 / 1e-4."""
    m = _pallas_interpret(monkeypatch)
    B, C_in, H, W, C_out, k, s, act = case
    x = rng.standard_normal((B, C_in, H, W)).astype(np.float32)
    w = (rng.standard_normal((C_out, C_in, k, k)) * 0.1).astype(np.float32)
    b = rng.standard_normal(C_out).astype(np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 1, 3))          # NHCW
    wj = jnp.asarray(w.transpose(2, 3, 1, 0))          # HWIO
    ref = np.asarray(m.small_conv2d(xj, wj, jnp.asarray(b), act, s))
    xt = _t(x).requires_grad_(True)
    got = sc.small_conv2d(xt, _t(w), _t(b), s, act)
    assert got.shape == (B, C_out, -(-H // s), -(-W // s))
    np.testing.assert_allclose(got.detach().numpy(),
                               ref.transpose(0, 2, 1, 3), atol=2e-5)

    g = rng.standard_normal(got.shape).astype(np.float32)
    gj = jnp.asarray(g.transpose(0, 2, 1, 3))
    dxj = jax.grad(lambda a: jnp.sum(
        m.small_conv2d(a, wj, jnp.asarray(b), act, s) * gj))(xj)
    (got * _t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(dxj).transpose(0, 2, 1, 3),
                               atol=1e-4)


def test_conv_dx_plain_is_autograd(rng):
    """`conv_dx_plain(g, w, x_shape, s, out, act)` is the input gradient of
    `conv_plain(..., act)`, the activation's derivative taken at `out`."""
    w = _t(rng.standard_normal((8, 3, 7, 7)) * 0.1)
    b = _t(rng.standard_normal(8))
    for act in (None, "relu", "leaky"):
        x = _t(rng.standard_normal((2, 3, 9, 14))).requires_grad_(True)
        out = sc.conv_plain(x, w, b, 2, act)
        g = _t(rng.standard_normal(tuple(out.shape)))
        (out * g).sum().backward()
        np.testing.assert_allclose(
            sc.conv_dx_plain(g, w, x.shape, 2, out.detach(), act).numpy(),
            x.grad.numpy(), atol=1e-5)
    with pytest.raises(ValueError):
        sc.conv_dx_plain(g, w, x.shape, 2, None, "relu")


@pytest.mark.parametrize("act", [None, "relu", "leaky"])
def test_conv_autograd_function_wiring(rng, monkeypatch, act):
    """`_SmallConv` with its kernels swapped for the plain versions: dx by
    the dx kernel, which gets the saved output and the activation (its
    derivative is fused there), dw/db only on request."""
    def fwd(x, w, b, s, a):
        fwd.launches += 1
        return sc.conv_plain(x, w, b, s, a)

    def dx(g, w, shape, s, out, a):
        dx.launches += 1
        assert a == act and (out is None) == (act is None)
        return sc.conv_dx_plain(g, w, shape, s, out, a)

    fwd.launches = dx.launches = 0
    monkeypatch.setattr(sc, "small_conv_fwd", fwd)
    monkeypatch.setattr(sc, "small_conv_dx", dx)
    x = _t(rng.standard_normal((1, 4, 10, 11)))
    w = _t(rng.standard_normal((6, 4, 3, 3)) * 0.3)
    b = _t(rng.standard_normal(6))
    g = _t(rng.standard_normal((1, 6, 5, 6)))

    xa = x.clone().requires_grad_(True)
    (sc._SmallConv.apply(xa, w, b, 2, act) * g).sum().backward()
    xr = x.clone().requires_grad_(True)
    (sc.conv_plain(xr, w, b, 2, act) * g).sum().backward()
    np.testing.assert_allclose(xa.grad.numpy(), xr.grad.numpy(), atol=1e-5)
    assert (fwd.launches, dx.launches) == (1, 1)

    wa, ba = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    wr, br = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    (sc._SmallConv.apply(x, wa, ba, 2, act) * g).sum().backward()
    (sc.conv_plain(x, wr, br, 2, act) * g).sum().backward()
    np.testing.assert_allclose(wa.grad.numpy(), wr.grad.numpy(), atol=1e-4)
    np.testing.assert_allclose(ba.grad.numpy(), br.grad.numpy(), atol=1e-4)
    assert dx.launches == 1  # no input gradient requested


def _run_plan(inp, packed, plan, out_hw):
    """The bf16 kernel's GEMMs of `plan` as plain products: per GEMM class
    and tap, the (strided) window of the channel-padded input times that
    tap's packed [c][n] weights, stored at the class's pixels."""
    B, C, _, _ = inp.shape
    kc, bn, S = plan.kc, 8 * plan.nf, plan.S
    nchunk = -(-C // kc)
    xp = torch.nn.functional.pad(inp, (8, 8 + S * out_hw[1], 8,
                                       8 + S * out_hw[0], 0,
                                       nchunk * kc - C))
    out = torch.zeros((B, plan.groups * bn, *out_hw), dtype=inp.dtype)
    for c, off in zip(plan.classes, plan.woffs):
        n = plan.groups * nchunk * c.ty * c.tx * kc * bn
        wk = packed[off:off + n].reshape(plan.groups, nchunk, c.ty, c.tx, kc,
                                         bn)
        wk = wk.permute(2, 3, 1, 4, 0, 5).reshape(c.ty, c.tx, nchunk * kc,
                                                  plan.groups * bn)
        acc = 0
        for jy in range(c.ty):
            for jx in range(c.tx):
                y0, x0 = 8 + c.by + jy, 8 + c.bx + jx
                win = xp[:, :, y0:y0 + S * c.hc:S, x0:x0 + S * c.wc:S]
                acc = acc + torch.einsum("bchw,cn->bnhw", win, wk[jy, jx])
        out[:, :, c.py::plan.OS, c.px::plan.OS][:, :, :c.hc, :c.wc] = acc
    return out[:, :plan.N]


@pytest.mark.parametrize("case", [
    # (B, C_in, H, W, C_out, k, stride)
    (1, 3, 9, 13, 20, 7, 2),      # stem class: k8 steps, 4 dx classes
    (2, 20, 11, 10, 7, 3, 2),     # two 16-channel chunks, odd sizes
    (1, 5, 8, 9, 70, 5, 1),       # N split across blocks (3 groups)
    (1, 17, 7, 12, 3, 5, 2),      # k5 stride 2
    (1, 6, 1, 5, 8, 3, 2),        # H = 1: dx's odd-row classes are empty
])
def test_conv_packed_weights_run_as_plain_gemm(rng, case):
    """The bf16 kernel's plan and packed weights, run as plain float64
    products per GEMM class (each dx parity class included), give
    `conv_plain` and `conv_dx_plain`: the tap sets, offsets, flips and
    channel transposes the kernel is handed are those of the conv."""
    B, C_in, H, W, C_out, k, s = case
    x = torch.from_numpy(rng.standard_normal((B, C_in, H, W)))
    w = torch.from_numpy(rng.standard_normal((C_out, C_in, k, k)))
    out = sc.conv_plain(x, w, None, s)
    plan = sc._plan("fwd", x.shape, C_out, k, s)
    got = _run_plan(x, sc._pack_weights(w, plan), plan, out.shape[2:])
    np.testing.assert_allclose(got.numpy(), out.numpy(), atol=1e-10)

    g = torch.from_numpy(rng.standard_normal(tuple(out.shape)))
    plan = sc._plan("dx", x.shape, C_out, k, s)
    assert len(plan.classes) == (1 if s == 1 else 4 if H > 1 else 2)
    got = _run_plan(g, sc._pack_weights(w, plan), plan, (H, W))
    np.testing.assert_allclose(got.numpy(),
                               sc.conv_dx_plain(g, w, x.shape, s).numpy(),
                               atol=1e-10)


@pytest.mark.parametrize("kind", ["fwd", "dx"])
def test_conv_plans_fill_the_card_at_main_path_shapes(kind):
    """Every main-path conv (RAFT's stem and layer1, PWCNet's 11 layers)
    plans ≥ 2 × 132 blocks within a block's shared memory, and each dx
    class of a k7 stride-2 conv has the 4×4 / 4×3 / 3×4 / 3×3 taps."""
    shapes = [((4, 3, 376, 1248), 64, 7, 2), ((4, 64, 188, 624), 64, 3, 1),
              ((2, 3, 384, 1280), 16, 3, 2), ((2, 16, 192, 640), 16, 3, 1),
              ((2, 16, 192, 640), 32, 3, 2), ((2, 32, 96, 320), 32, 3, 1),
              ((2, 32, 96, 320), 64, 3, 2), ((2, 64, 48, 160), 64, 3, 1),
              ((2, 64, 48, 160), 96, 3, 2), ((1, 64, 96, 320), 32, 3, 1)]
    for x_shape, c_out, k, s in shapes:
        for masked in ((False, True) if kind == "dx" else (False,)):
            plan = sc._plan(kind, x_shape, c_out, k, s, masked)
            assert plan.blocks >= sc._MIN_BLOCKS, (x_shape, plan)
            assert plan.smem <= sc._SMEM_MAX
    if kind == "dx":
        plan = sc._plan("dx", (1, 3, 20, 22), 8, 7, 2)
        assert [(c.ty, c.tx) for c in plan.classes] == [(3, 3), (3, 4),
                                                        (4, 3), (4, 4)]


def test_conv_cpu_dispatch_is_plain(rng):
    x = _t(rng.standard_normal((1, 3, 8, 8)))
    w = _t(rng.standard_normal((4, 3, 3, 3)))
    before = (sc.small_conv_fwd.launches, sc.small_conv_dx.launches)
    np.testing.assert_array_equal(sc.small_conv2d(x, w, None, 1).numpy(),
                                  sc.conv_plain(x, w, None, 1).numpy())
    assert (sc.small_conv_fwd.launches, sc.small_conv_dx.launches) == before


# ------------------------------------------------------ local corr ---

@pytest.mark.parametrize("case", [
    # (B, H, W, C, patch, stride)
    (2, 32, 40, 8, 9, 1),    # PWCNet's patch
    (1, 33, 36, 8, 5, 1),    # odd height, patch 5
    (1, 32, 32, 8, 5, 2),    # global flavour: max_disp 4, stride2 2
])
def test_local_corr_plain_matches_xla_and_pallas(rng, case):
    """Values and (df1, df2) against `pcfa_tpu`'s XLA correlation (autodiff
    for the gradients) and the Pallas `_forward` / `_backward` in interpret
    mode. Maps hold ≥ 1024 pixels, where the Pallas backward runs its
    kernels. float32 sums of ≤ 81·C products: 1e-5 / 1e-4."""
    from pcfa_tpu.ops.pallas.local_corr import _backward, _forward

    B, H, W, C, patch, stride = case
    f1 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    f2 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    g = rng.standard_normal((B, H, W, patch * patch)).astype(np.float32)
    j1, j2 = jnp.asarray(f1), jnp.asarray(f2)
    if stride == 1:
        xla = lambda a, b: jcorr.local_correlation(a, b, patch)  # noqa: E731
    else:
        R = (patch - 1) // 2 * stride
        xla = lambda a, b: jcorr.global_correlation(a, b, R, stride)  # noqa

    t1, t2 = _t(f1).requires_grad_(True), _t(f2).requires_grad_(True)
    got = lc.local_corr_plain(t1, t2, patch, stride)
    assert got.shape == (B, H, W, patch * patch)
    ref, vjp = jax.vjp(xla, j1, j2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    np.testing.assert_allclose(
        got.detach().numpy(),
        np.asarray(_forward(j1, j2, patch, stride, interpret=True)),
        atol=1e-5)

    (got * _t(g)).sum().backward()
    bwd = lc.local_corr_bwd_plain(_t(g), _t(f1), _t(f2), patch, stride)
    pallas = _backward(j1, j2, jnp.asarray(g), patch, stride, interpret=True)
    for port, plain_bwd, r, p in zip((t1.grad, t2.grad), bwd, vjp(
            jnp.asarray(g)), pallas):
        np.testing.assert_allclose(port.numpy(), np.asarray(r), atol=1e-4)
        np.testing.assert_allclose(plain_bwd.numpy(), np.asarray(r),
                                   atol=1e-4)
        np.testing.assert_allclose(port.numpy(), np.asarray(p), atol=1e-4)


def test_local_corr_rows_then_columns(rng):
    """Channel (dy+R)·P + (dx+R): dy shifts rows (not RAFT's transposed
    window). f2 = a one-hot column index map picks the shifted column."""
    H, W, R = 7, 11, 2
    P = 2 * R + 1
    f1 = torch.ones(1, H, W, 1)
    f2 = torch.arange(W, dtype=torch.float32).expand(1, H, W)[..., None]
    out = lc.local_corr_plain(f1, f2, P, 1)[0, 3, 5]  # pixel (y 3, x 5)
    dy, dx = np.meshgrid(np.arange(-R, R + 1), np.arange(-R, R + 1),
                         indexing="ij")
    np.testing.assert_array_equal(out.numpy(), (5 + dx).reshape(-1))


def test_local_corr_bf16_plain_matches_xla(rng):
    """bf16 maps: the plain version sums in float32 and rounds once."""
    f1 = rng.standard_normal((1, 6, 20, 32)).astype(np.float32)
    f2 = rng.standard_normal((1, 6, 20, 32)).astype(np.float32)
    ref = np.asarray(jcorr.local_correlation(jnp.asarray(f1),
                                             jnp.asarray(f2), 9))
    got = lc.local_corr_plain(_t(f1).bfloat16(), _t(f2).bfloat16(), 9, 1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=3e-2)


def test_local_corr_autograd_function_wiring(rng, monkeypatch):
    """`_LocalCorr` with its kernels swapped for the plain versions: both
    maps get the plain gradient and each kernel counts one launch."""
    def fwd(a, b, p, s):
        fwd.launches += 1
        return lc.local_corr_plain(a, b, p, s)

    def bwd(g, a, b, p, s):
        bwd.launches += 1
        return lc.local_corr_bwd_plain(g, a, b, p, s)

    fwd.launches = bwd.launches = 0
    monkeypatch.setattr(lc, "local_corr_fwd", fwd)
    monkeypatch.setattr(lc, "local_corr_bwd", bwd)
    f1 = _t(rng.standard_normal((2, 5, 6, 4))).requires_grad_(True)
    f2 = _t(rng.standard_normal((2, 5, 6, 4))).requires_grad_(True)
    g = _t(rng.standard_normal((2, 5, 6, 25)))
    (lc._LocalCorr.apply(f1, f2, 5, 1) * g).sum().backward()
    ref = lc.local_corr_bwd_plain(g, f1, f2, 5, 1)
    np.testing.assert_allclose(f1.grad.numpy(), ref[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(f2.grad.numpy(), ref[1].numpy(), atol=1e-6)
    assert (fwd.launches, bwd.launches) == (1, 1)


def test_local_corr_cpu_dispatch_is_plain(rng):
    f1 = _t(rng.standard_normal((1, 4, 5, 3)))
    before = (lc.local_corr_fwd.launches, lc.local_corr_bwd.launches)
    np.testing.assert_array_equal(lc.local_corr(f1, f1, 9, 1).numpy(),
                                  lc.local_corr_plain(f1, f1, 9, 1).numpy())
    assert (lc.local_corr_fwd.launches, lc.local_corr_bwd.launches) == before


# ---------------------------------------------------------- segsum ---

@pytest.mark.parametrize("case", ["one_cell", "sparse_tail", "tiny",
                                  "multi_chunk"])
def test_segment_rows_plain_matches_pallas(rng, case):
    """The plain row-sum against `segment_rows_pallas` (interpret mode) and
    a float64 truth, on the edge cases of tests/test_ops_warp.py: every
    row in one cell, a long empty tail, fewer rows than a chunk, many
    chunks. atol 2e-5 / rtol 2e-4 as there (2000-way collisions carry
    float32 summation noise on either side)."""
    from pcfa_tpu.ops.pallas import segsum as jsegsum

    N, nrows = {"one_cell": (2000, 5000), "sparse_tail": (300, 9000),
                "tiny": (17, 40), "multi_chunk": (6000, 300)}[case]
    if case == "one_cell":
        idx = np.full(N, 4321, np.int64)
    elif case == "sparse_tail":
        idx = rng.integers(0, 50, N)
    else:
        idx = rng.integers(0, nrows, N)
    upd = rng.standard_normal((N, 12)).astype(np.float32)
    want = np.zeros((nrows, 12))
    np.add.at(want, idx, upd.astype(np.float64))
    tol = dict(atol=2e-5, rtol=2e-4)

    got = sg.segment_rows(torch.from_numpy(idx), _t(upd), nrows)
    assert got.dtype == torch.float32 and got.shape == (nrows, 12)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    ref = jsegsum.segment_rows_pallas(jnp.asarray(idx, jnp.int32),
                                      jnp.asarray(upd), nrows, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


def test_segment_rows_dtypes_and_dispatch(rng):
    """bf16 rows sum in float32 and come back bf16; float64 stays float64;
    CPU tensors never launch the kernel."""
    idx = torch.from_numpy(rng.integers(0, 7, 300))
    upd = _t(rng.standard_normal((300, 5)))
    before = sg.segment_rows_cuda.launches
    want = sg.segment_rows(idx, upd.double(), 7)
    assert want.dtype == torch.float64
    got = sg.segment_rows(idx, upd.bfloat16(), 7)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(),
        sg.segment_rows_plain(idx, upd.bfloat16().float(), 7).numpy(),
        rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(sg.segment_rows(idx, upd, 7).numpy(),
                               want.numpy(), atol=1e-5)
    assert sg.segment_rows_cuda.launches == before
