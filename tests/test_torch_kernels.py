"""The two kernels of the RAFT slice on the CPU: their plain versions vs
`pcfa_tpu` (the XLA lookup, the Pallas kernels in interpret mode) and the
autograd wiring of each wrapper. The CUDA kernels themselves are held
against the plain versions on the card by `tests/test_torch_cuda.py` and
`chip_smoke.py`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcfa_tpu.ops import correlation as jcorr
from pcfa_tpu.ops.pallas.corr_lookup import corr_lookup_pallas
from pcfa_tpu_torch.ops import corr_lookup as cl
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
    x = _t(rng.standard_normal((2, 3, 9, 14))).requires_grad_(True)
    w = _t(rng.standard_normal((8, 3, 7, 7)) * 0.1)
    out = sc.conv_plain(x, w, None, 2)
    g = _t(rng.standard_normal(tuple(out.shape)))
    (out * g).sum().backward()
    np.testing.assert_allclose(
        sc.conv_dx_plain(g, w, x.shape, 2).numpy(), x.grad.numpy(),
        atol=1e-5)


@pytest.mark.parametrize("act", [None, "relu", "leaky"])
def test_conv_autograd_function_wiring(rng, monkeypatch, act):
    """`_SmallConv` with its kernels swapped for the plain versions: the
    activation mask from the saved output, dx by the dx kernel, dw/db only
    on request."""
    def fwd(x, w, b, s, a):
        fwd.launches += 1
        return sc.conv_plain(x, w, b, s, a)

    def dx(g, w, shape, s):
        dx.launches += 1
        return sc.conv_dx_plain(g, w, shape, s)

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


def test_conv_cpu_dispatch_is_plain(rng):
    x = _t(rng.standard_normal((1, 3, 8, 8)))
    w = _t(rng.standard_normal((4, 3, 3, 3)))
    before = (sc.small_conv_fwd.launches, sc.small_conv_dx.launches)
    np.testing.assert_array_equal(sc.small_conv2d(x, w, None, 1).numpy(),
                                  sc.conv_plain(x, w, None, 1).numpy())
    assert (sc.small_conv_fwd.launches, sc.small_conv_dx.launches) == before
