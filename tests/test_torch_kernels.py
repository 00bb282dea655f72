"""The port's kernels on the CPU (the RAFT slice's corr lookup and small
conv, PWCNet's patch correlation and segment row-sum): their plain
versions vs `pcfa_tpu` (the XLA ops, the Pallas kernels in interpret mode)
and the autograd wiring of each wrapper. The CUDA kernels themselves are
held against the plain versions on the card by `tests/test_torch_cuda.py`
and `chip_smoke.py`."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pcfa_tpu.ops import correlation as jcorr
from pcfa_tpu.ops.pallas.corr_lookup import corr_lookup_pallas
from pcfa_tpu_torch.ops import corr_lookup as cl
from pcfa_tpu_torch.ops import local_corr as lc
from pcfa_tpu_torch.ops import segsum as sg
from pcfa_tpu_torch.ops import small_conv as sc
from pcfa_tpu_torch.ops.correlation import corr_lookup, corr_lookup_window


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op torch thread while this module runs: the suite runs a
    pytest worker per core, and torch's default of a thread per core makes
    the workers contend (a planner case of test_torch_kernels.py took 96 s
    beside five other workers, 8 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_lookup_autograd_function_wiring(rng):
    """`_CorrWindow` on CPU tensors (the plain versions inside the same
    Function the kernels use) on a plain list of levels: each lookup
    returns its own gradient, the maps get the plain gradient, coords
    none, and no kernel launch is counted."""
    pyr, coords = _lookup_inputs(rng)
    levels = _port_pyr(pyr, requires_grad=True)
    c = _t(coords).reshape(-1, 2)
    before = (cl.corr_window_fwd.launches, cl.corr_window_bwd.launches)
    out = cl._CorrWindow.apply(c, R, None, *levels)
    g = _t(rng.standard_normal(tuple(out.shape)))
    (out * g).sum().backward()
    ref = cl.corr_window_bwd_plain(g, levels, c, R)
    for lv, r in zip(levels, ref):
        np.testing.assert_allclose(lv.grad.numpy(), r.numpy(), atol=1e-6)
    assert (cl.corr_window_fwd.launches, cl.corr_window_bwd.launches) == before


def _accumulation_graph(rng, case):
    """float64 leaves standing for a pyramid's levels, coords and
    cotangents of three lookups that reach the loss, a fourth lookup's
    coords, and weights of a second use of the levels."""
    shapes = [(12, 20), (6, 10), (3, 5), (2, 2)]
    n = 30
    leaves = [torch.from_numpy(rng.standard_normal((n, h, w)))
              .requires_grad_(True) for h, w in shapes]
    cs = [torch.from_numpy(rng.uniform(-4, 24, (n, 2))) for _ in range(4)]
    gs = [torch.from_numpy(rng.standard_normal((n, 4 * P * P)))
          for _ in range(3)]
    ws = [torch.from_numpy(rng.standard_normal((n, h, w)))
          for h, w in shapes]

    def loss(levels, lookup):
        out = sum((lookup(levels, c) * g).sum() for c, g in zip(cs, gs))
        if case == "one_unused":
            lookup(levels, cs[3])  # never reaches the loss
        if case == "second_use":
            out = out + sum((lv * w).sum() for lv, w in zip(levels, ws))
        return out

    return leaves, loss


def _acc_lookup(levels, c):
    return cl.corr_window(levels, c, R)


def _plain_lookup(levels, c):
    return cl.corr_window_plain(levels, c, R)


@pytest.mark.parametrize("case", ["all_reach_loss", "one_unused",
                                  "second_use"])
def test_lookup_accumulates_one_gradient_per_pyramid(rng, case):
    """Lookups on `pyramid_with_grad`'s levels add into one buffer per
    level, which `_PyramidGrad` hands on (with the gradient of any other
    use of the levels): float64, against plain autograd's sum of the
    per-lookup gradients, with 3 lookups that reach the loss, one more
    that does not, or the levels also used by a second op. No kernel
    launch is counted on the CPU."""
    leaves, loss = _accumulation_graph(rng, case)
    before = (cl.corr_window_fwd.launches, cl.corr_window_bwd.launches)
    pyr = cl.pyramid_with_grad(leaves)
    assert pyr.acc is not None and len(pyr) == len(leaves)
    loss(pyr, _acc_lookup).backward()
    assert pyr.acc.bufs is None  # handed on and dropped
    got = [lv.grad.clone() for lv in leaves]
    for lv in leaves:
        lv.grad = None
    loss(leaves, _plain_lookup).backward()
    for a, lv in zip(got, leaves):
        np.testing.assert_allclose(a.numpy(), lv.grad.numpy(), rtol=1e-12,
                                   atol=1e-12)
    assert (cl.corr_window_fwd.launches, cl.corr_window_bwd.launches) == before


def test_lookup_accumulation_with_retain_graph(rng):
    """Two backward passes through one graph (`retain_graph=True`): each
    zero-fills its own buffers, so the second adds the same gradient
    again."""
    leaves, loss = _accumulation_graph(rng, "second_use")
    out = loss(cl.pyramid_with_grad(leaves), _acc_lookup)
    out.backward(retain_graph=True)
    once = [lv.grad.clone() for lv in leaves]
    out.backward()
    for a, lv in zip(once, leaves):
        np.testing.assert_allclose(lv.grad.numpy(), 2 * a.numpy(),
                                   rtol=1e-12, atol=1e-12)
    for lv in leaves:
        lv.grad = None
    loss(leaves, _plain_lookup).backward()
    for a, lv in zip(once, leaves):
        np.testing.assert_allclose(a.numpy(), lv.grad.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_lookup_bwd_acc_plain_matches_mm_rf_vjp(rng):
    """The plain accumulating backward, two lookups added into one set of
    float64 buffers, against the sum of two VJPs of JAX's default lookup
    (`corr_lookup_mm_rf`) in float64."""
    pyr, c1 = _lookup_inputs(rng)
    c2 = c1 + rng.standard_normal(c1.shape) * 2.0
    gs = [rng.standard_normal((1, 8, 8, 4 * P * P)) for _ in range(2)]
    with jax.enable_x64(True):
        jp = [jnp.asarray(lv, jnp.float64) for lv in pyr]
        want = [np.zeros(lv.shape) for lv in pyr]
        for c, g in zip((c1, c2), gs):
            _, vjp = jax.vjp(lambda p: jcorr.corr_lookup_mm_rf(
                p, jnp.asarray(c, jnp.float64), R), jp)
            for w, d in zip(want, vjp(jnp.asarray(g))[0]):
                w += np.asarray(d)
    dmaps = [torch.zeros(lv.shape[:3], dtype=torch.float64) for lv in pyr]
    for c, g in zip((c1, c2), gs):
        got = cl.corr_window_bwd_acc_plain(
            torch.from_numpy(g.reshape(64, -1)), dmaps,
            torch.from_numpy(np.asarray(c, np.float64).reshape(-1, 2)), R)
        assert got is dmaps
    for d, w in zip(dmaps, want):
        np.testing.assert_allclose(d.numpy(), w[..., 0], rtol=1e-12,
                                   atol=1e-12)


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



def _take(f, b, ys, xs):
    """f[b] at rows ys × columns xs, zero outside the map (a staged tile)."""
    H, W = f.shape[1:3]
    ys, xs = torch.tensor(list(ys)), torch.tensor(list(xs))
    t = f[b][ys.clamp(0, H - 1)][:, xs.clamp(0, W - 1)]
    ok = ((ys >= 0) & (ys < H))[:, None, None] & ((xs >= 0)
                                                   & (xs < W))[None, :, None]
    return t * ok


def _blocks(plan, H, S):
    """(x0, ybase) of every block of `plan`: x tiles, then row classes
    (stride rows interleave) and row tiles."""
    for by in range(plan.gy):
        cls, ty = by % S, by // S
        for bx in range(plan.gx):
            yield bx * 16 * plan.mf, cls + S * ty * plan.th


def _band(d, patch, S):
    """The kernels' band rule: offset d is shift d / S when whole, in
    [0, patch)."""
    return (d >= 0) & (d % S == 0) & (d // S < patch)


def _emulate_fwd(plan, f1, f2, patch, S):
    """The forward kernel's blocks as plain float64 products: each block's
    zero-filled f1 tile and halo rows, per (row, shift row, 16-pixel
    fragment) and channel chunk the 16 × 8·nf product, of which the band
    goes to the block's out tile; every output element written once."""
    B, H, W, C = f1.shape
    rad, tw, kc = (patch - 1) // 2 * S, 16 * plan.mf, plan.kc
    pad = (0, plan.nchunk * kc - C)
    f1, f2 = F.pad(f1, pad), F.pad(f2, pad)
    xi, hc = torch.meshgrid(torch.arange(16), torch.arange(8 * plan.nf),
                            indexing="ij")
    band = _band(hc - xi, patch, S)
    ix = ((hc - xi) // S)[band]
    ysplit = -(-patch // plan.pb)
    out = torch.full((B, H, W, patch * patch), float("nan"), dtype=f1.dtype)
    for bz in range(plan.gz):
        b, iy0 = bz // ysplit, (bz % ysplit) * plan.pb
        pbe = min(plan.pb, patch - iy0)
        for x0, ybase in _blocks(plan, H, S):
            hy0 = ybase + iy0 * S - rad
            a = _take(f1, b, [ybase + r * S for r in range(plan.th)],
                      range(x0, x0 + tw))
            halo = _take(f2, b, [hy0 + h * S for h in
                                 range(plan.th + pbe - 1)],
                         range(x0 - rad, x0 - rad + plan.hws))
            ot = torch.zeros((plan.th, tw, pbe, patch), dtype=f1.dtype)
            for k in range(plan.nchunk):
                ch = slice(k * kc, (k + 1) * kc)
                for r in range(plan.th):
                    for iyl in range(pbe):
                        for m in range(plan.mf):
                            px = slice(16 * m, 16 * m + 16)
                            prod = a[r, px, ch] @ halo[
                                r + iyl, 16 * m:16 * m + 8 * plan.nf, ch].T
                            ot[r, px, iyl].index_put_(
                                (xi[band], ix), prod[band], accumulate=True)
            for r in range(plan.th):
                y, n = ybase + r * S, min(tw, W - x0)
                if y < H:
                    out[b, y, x0:x0 + n, iy0 * patch:(iy0 + pbe) * patch] = (
                        ot[r, :n].reshape(n, -1) / C)
    return out


def _stage_g(plan, g, b, which, x0, ybase, patch, S, esz):
    """The backward kernel's staged g (`bwd_stage_g`), flat, NaN where
    nothing is staged. Rows (df1: the block's th rows; df2 with gmode 1:
    the th + patch − 1 halo rows) sit `gcap` elements apart, each shifted
    so that it agrees with its source modulo 16 bytes, counted from the
    start of g (the image's offset included); gmode 0 stages, per output
    row r and shift row iy, the P entries of each halo pixel."""
    B, H, W, P2 = g.shape
    rad, tw, V = (patch - 1) // 2 * S, 16 * plan.mf, 16 // esz
    gs = torch.full((plan.g_bytes // esz,), float("nan"), dtype=g.dtype)
    if which == 0 or plan.gmode == 1:
        ys = ([ybase + r * S for r in range(plan.th)] if which == 0 else
              [ybase - rad + h * S for h in range(plan.rows)])
        xs, npx = (x0, tw) if which == 0 else (x0 - rad, plan.hws)
        for i, y in enumerate(ys):
            span = _take(g, b, [y], range(xs, xs + npx)).reshape(-1)
            shift = ((b * H + y) * W + xs) * P2 % V
            row = torch.zeros(plan.gcap, dtype=g.dtype)
            row[shift:shift + span.numel()] = span
            gs[i * plan.gcap:(i + 1) * plan.gcap] = row
        return gs
    run = plan.hws * patch
    for r in range(plan.th):
        for iy in range(patch):
            yy = ybase + (r + patch - 1 - iy) * S - rad
            t = _take(g, b, [yy], range(x0 - rad, x0 - rad + plan.hws))[0]
            q = r * patch + iy
            gs[q * run:(q + 1) * run] = t[:, iy * patch:(iy + 1)
                                           * patch].reshape(-1)
    return gs


def _g_base(plan, which, x0, ybase, r, iy, h, patch, S, esz, W, b, H):
    """Where shift row iy's g values for output row r start in the staged
    g, and the distance between neighbouring pixels there (`g_base`)."""
    rad, P2, V = (patch - 1) // 2 * S, patch * patch, 16 // esz
    if which == 0 or plan.gmode == 1:
        y, xs, i = ((ybase + r * S, x0, r) if which == 0 else
                    (ybase + h * S - rad, x0 - rad, h))
        return i * plan.gcap + ((b * H + y) * W + xs) * P2 % V + iy * patch, P2
    return (r * patch + iy) * plan.hws * patch, patch


def _emulate_bwd(plan, g, f1, f2, patch, S, esz):
    """The backward kernel's blocks as plain float64 products: per block
    (df1 or df2, channel group, tile) g staged as the kernel stages it and
    the halo rows, and per (row, 16-pixel fragment) the sum over shift rows
    and 16-column k steps of the g band, read from the staged g at the
    kernel's offsets, times the halo; every gradient element written
    once."""
    B, H, W, C = f1.shape
    rad, tw, kc = (patch - 1) // 2 * S, 16 * plan.mf, plan.kc
    pad = (0, plan.nchunk * kc - C)
    feats = F.pad(f2, pad), F.pad(f1, pad)
    xi, hc = torch.meshgrid(torch.arange(16), torch.arange(16 * plan.nf),
                            indexing="ij")
    grads = [torch.full((B, H, W, C), float("nan"), dtype=f1.dtype)
             for _ in range(2)]
    for z in range(plan.gz):
        which, b = z & 1, (z >> 1) // plan.cgroups
        d = hc - xi if which == 0 else xi + 2 * rad - hc
        band = _band(d, patch, S)
        ix = torch.where(band, d // S, 0)
        for x0, ybase in _blocks(plan, H, S):
            hy0 = ybase - rad
            halo = _take(feats[which], b, [hy0 + h * S for h in
                                           range(plan.rows)],
                         range(x0 - rad, x0 - rad + plan.hws))
            gs = _stage_g(plan, g, b, which, x0, ybase, patch, S, esz)
            for k in range((z >> 1) % plan.cgroups, plan.nchunk,
                           plan.cgroups):
                ch = slice(k * kc, (k + 1) * kc)
                for r in range(plan.th):
                    y = ybase + r * S
                    if y >= H:
                        continue
                    for m in range(plan.mf):
                        acc = 0
                        for iy in range(patch):
                            h = r + iy if which == 0 else r + patch - 1 - iy
                            if not 0 <= hy0 + h * S < H:
                                continue
                            base, gps = _g_base(plan, which, x0, ybase, r,
                                                iy, h, patch, S, esz, W, b, H)
                            px = 16 * m + (xi if which == 0 else hc)
                            a = torch.where(band, gs[torch.where(
                                band, base + px * gps + ix, 0)], 0.0)
                            acc = acc + a @ halo[h, 16 * m:16 * m
                                                 + 16 * plan.nf, ch]
                        n, c1 = min(16, W - x0 - 16 * m), min(C, k * kc + kc)
                        if n > 0:
                            grads[which][b, y, x0 + 16 * m:x0 + 16 * m + n,
                                         k * kc:c1] = (
                                acc[:n, :c1 - k * kc] / C)
    return grads


# (B, H, W, C, patch, stride); between them, the plans that
# `_emulated_plans` picks take every branch `_LC_BRANCHES` names
_LC_CASES = [
    (1, 6, 20, 196, 9, 1),     # PWCNet level 6: C not a multiple of 16
    (2, 7, 45, 33, 5, 1),      # odd sizes, ragged chunk, W % 16 != 0
    (1, 2, 3, 5, 9, 1),        # map smaller than the patch
    (1, 9, 36, 24, 21, 2),     # FlowNetC's patch and stride
    (2, 13, 50, 40, 9, 1),     # several row tiles; the second image's g
]
# what a plan does, by kind: the branches of the kernels' tiling and
# staging that the emulation models (how warps share a product's k steps
# or channel groups, and buffering, leave the sums as they are)
_LC_BRANCHES = {
    "fwd": {"th > 1": lambda p, P: p.th > 1, "mf = 2": lambda p, P: p.mf == 2,
            "shift rows split": lambda p, P: p.pb < P,
            "channel chunks": lambda p, P: p.nchunk > 1},
    "bwd": {"th > 1": lambda p, P: p.th > 1, "mf = 2": lambda p, P: p.mf == 2,
            "g rows (gmode 1)": lambda p, P: p.gmode == 1,
            "g runs (gmode 0)": lambda p, P: p.gmode == 0,
            "channel groups": lambda p, P: p.cgroups > 1,
            "chunks per block": lambda p, P: p.nchunk > p.cgroups},
}


def _emulated_plans(kind, case, esz, most=4):
    """The plan `_plan` picks, then candidates of `_candidates`, in rank
    order, that take a branch none of those before took."""
    B, H, W, C, patch, stride = case
    ranked = sorted(lc._candidates(kind, B, H, W, C, patch, stride, esz),
                    key=lambda kp: kp[0])
    picked, seen = [], set()
    for _, plan in ranked:
        took = {n for n, f in _LC_BRANCHES[kind].items() if f(plan, patch)}
        if not picked or took - seen:
            picked.append(plan)
            seen |= took
        if len(picked) == most:
            break
    assert picked[0] == lc._plan(kind, B, H, W, C, patch, stride, esz)
    return picked


@pytest.mark.parametrize("case", _LC_CASES)
@pytest.mark.parametrize("esz", [2, 4])
def test_local_corr_plans_run_as_banded_products(rng, case, esz):
    """The kernels' plans (bf16 and float32; the planned one and others
    that take other branches), run block by block as plain float64 banded
    products with the kernels' tiling, band rule (the stride-2 even
    offsets included), staged g and ragged edges, give `local_corr_plain`
    and `local_corr_bwd_plain`, and write every output element once."""
    B, H, W, C, patch, stride = case
    f1, f2 = (torch.from_numpy(rng.standard_normal((B, H, W, C)))
              for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((B, H, W, patch * patch)))
    ref = lc.local_corr_plain(f1, f2, patch, stride).numpy()
    for plan in _emulated_plans("fwd", case, esz):
        got = _emulate_fwd(plan, f1, f2, patch, stride)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-12,
                                   err_msg=str(plan))
    refs = lc.local_corr_bwd_plain(g, f1, f2, patch, stride)
    for plan in _emulated_plans("bwd", case, esz):
        got = _emulate_bwd(plan, g, f1, f2, patch, stride, esz)
        for a, b in zip(got, refs):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12,
                                       err_msg=str(plan))


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_local_corr_emulated_plans_take_every_branch(kind):
    """Between them, the plans that the banded-product test emulates take
    every branch of `_LC_BRANCHES`, in bf16."""
    took = {n for case in _LC_CASES for plan in _emulated_plans(kind, case, 2)
            for n, f in _LC_BRANCHES[kind].items() if f(plan, case[4])}
    assert took == set(_LC_BRANCHES[kind])


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_local_corr_plans_fill_the_card(kind):
    """bf16 at 384×1280, B = 1: PWCNet's levels 2–4 and FlowNetC launch at
    least one block per SM; the forward of the small levels 5–6 splits
    each product's channels across the block's warps where it has fewer
    blocks, the backward splits their channels across blocks. Every plan
    fits a block's shared memory and the grid's limits."""
    levels = [(6, 20, 196, 9, 1), (12, 40, 128, 9, 1), (24, 80, 96, 9, 1),
              (48, 160, 64, 9, 1), (96, 320, 32, 9, 1), (48, 160, 256, 21, 2)]
    for H, W, C, patch, stride in levels:
        plan = lc._plan(kind, 1, H, W, C, patch, stride, 2)
        assert plan.smem <= lc._SMEM_MAX and plan.gy <= 65535, plan
        if kind == "fwd" and plan.blocks < lc._SMS:
            assert H <= 12, plan
            warps = plan.th * plan.pb * plan.mf * plan.ksplit
            assert warps >= plan.threads // 32, plan
        else:
            assert plan.blocks >= lc._SMS, (H, plan)
        if kind == "bwd" and H <= 12:
            assert plan.cgroups > 1, plan


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

    got = sg.segment_rows_plain(torch.from_numpy(idx), _t(upd), nrows)
    assert got.dtype == torch.float32 and got.shape == (nrows, 12)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    ref = jsegsum.segment_rows_pallas(jnp.asarray(idx, jnp.int32),
                                      jnp.asarray(upd), nrows, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


def test_segment_rows_dtypes_and_dispatch(rng):
    """bf16 rows sum in float32 and come back bf16; float64 stays float64;
    the sampler's backward on CPU tensors is the plain version and never
    launches the kernel."""
    from pcfa_tpu_torch.ops import warp

    idx = torch.from_numpy(rng.integers(0, 7, 300))
    upd = _t(rng.standard_normal((300, 5)))
    want = sg.segment_rows_plain(idx, upd.double(), 7)
    assert want.dtype == torch.float64
    got = sg.segment_rows_plain(idx, upd.bfloat16(), 7)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(),
        sg.segment_rows_plain(idx, upd.bfloat16().float(), 7).numpy(),
        rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(sg.segment_rows_plain(idx, upd, 7).numpy(),
                               want.numpy(), atol=1e-5)

    before = sg.warp_bwd_cuda.launches
    args = _warp_state(rng, (2, 5, 6, 3), True)
    for x, y in zip(sg.warp_bwd(*args), sg.warp_bwd_plain(*args)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    img = _t(rng.standard_normal((2, 5, 6, 3))).requires_grad_()
    grid = _t(rng.uniform(-1.2, 1.2, (2, 4, 4, 2))).requires_grad_()
    for mode in ("zeros", "border"):
        (warp.grid_sample(img, grid, False, mode) ** 2).sum().backward()
    assert sg.warp_bwd_cuda.launches == before
    with pytest.raises(ValueError, match="device"):
        sg.warp_bwd(*[t.to("meta") if isinstance(t, torch.Tensor) else t
                      for t in args])


def _warp_state(rng, shape, zeros, coords=None, g_dtype=torch.float32):
    """The packed sampler's saved forward state and a cotangent, as
    `warp_bwd`'s arguments: an image of `shape`, and 2·(H+2)·(W+1)
    samples at `coords` (B, Hg, Wg, 2) pixel positions (default: uniform
    over the image and a pixel beyond each edge)."""
    from pcfa_tpu_torch.ops import warp

    B, H, W, C = shape
    img = _t(rng.standard_normal(shape)).to(g_dtype)
    if coords is None:
        coords = rng.uniform(-1.5, 1.0, (B, H + 2, W + 1, 2)) * (W, H) \
            + rng.uniform(0, 1, (B, H + 2, W + 1, 2)) * (2 * W, 2 * H)
    ix, iy = _t(coords[..., 0]), _t(coords[..., 1])
    idx, w4, mask4, a, b = warp._corner_weights(shape, ix, iy, zeros)
    win = warp._pack_windows(img)[idx].reshape(-1, 4, C)
    g = _t(rng.standard_normal((*ix.shape, C))).to(g_dtype)
    return g, win, idx, w4, mask4, a, b, shape, img.dtype


def _warp_bwd_emulated(g, win, idx, w4, mask4, a, b, shape):
    """`csrc/segsum.cu`'s formulation in float64: each sample's window
    base decoded from idx, each corner's w·g added to its clamped image
    cell (a zero weight adds nothing), the four corner dots masked, then
    the two bilinear formulas."""
    B, H, W, C = shape
    N = idx.shape[0]
    g, win, w4, a, b = (t.double() for t in (g.reshape(N, C), win, w4,
                                             a.reshape(N), b.reshape(N)))
    c0, q = idx % (W + 1), idx // (W + 1)
    r0, bb = q % (H + 1), q // (H + 1)
    rows = [(r0 - 1).clamp(0, H - 1), r0.clamp(max=H - 1)]
    cols = [(c0 - 1).clamp(0, W - 1), c0.clamp(max=W - 1)]
    dimg = torch.zeros((B * H * W, C), dtype=torch.float64)
    for k in range(4):
        cell = (bb * H + rows[k // 2]) * W + cols[k % 2]
        keep = w4[:, k] != 0
        dimg.index_add_(0, cell[keep], w4[keep, k, None] * g[keep])
    dot = (win * g[:, None, :]).sum(-1)
    if mask4 is not None:
        dot = torch.where(mask4, dot, 0.0)
    dix = (1 - b) * (dot[:, 1] - dot[:, 0]) + b * (dot[:, 3] - dot[:, 2])
    diy = (1 - a) * (dot[:, 2] - dot[:, 0]) + a * (dot[:, 3] - dot[:, 1])
    return dimg.reshape(shape), dix, diy


@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("case", ["c3", "c32_b2", "one_pixel_wide",
                                  "one_cell", "nan_far"])
def test_warp_bwd_clamped_splat_is_the_folds(rng, mode, case):
    """The kernel's formulation (each corner's w·g straight onto its
    clamped cell, zero weights skipped, dots in the same pass), emulated
    in float64, equals the plain version's row-sum, four shifted adds and
    border folds in float64 (1e-12): C = 3 and 32 at B = 2, a one-pixel-
    wide image, every sample on one cell, NaN and ±1e30 coordinates."""
    shape = {"c3": (2, 5, 7, 3), "c32_b2": (2, 4, 6, 32),
             "one_pixel_wide": (1, 6, 1, 4), "one_cell": (1, 5, 6, 8),
             "nan_far": (2, 4, 5, 3)}[case]
    B, H, W, C = shape
    coords = None
    if case == "one_cell":
        coords = np.broadcast_to((2.3, 1.6), (B, 9, 9, 2)).copy()
    elif case == "nan_far":
        coords = rng.uniform(-2, 6, (B, 4, 5, 2))
        coords[0, 0] = [(np.nan, 1.0), (2.0, np.nan), (1e30, 1.0),
                        (-1e30, 2.0), (1.5, 1e30)]
        coords[1, 1, :2] = [(-1e30, -1e30), (W - 1.0, H - 1.0)]
    args = _warp_state(rng, shape, mode == "zeros", coords)
    got = _warp_bwd_emulated(*args[:-2], shape)
    ref = sg.warp_bwd_plain(*(t.double() if isinstance(t, torch.Tensor)
                              and t.is_floating_point() else t
                              for t in args[:-1]), torch.float64)
    for x, y in zip(got, ref):
        assert y.dtype == torch.float64
        torch.testing.assert_close(x.reshape(y.shape), y, rtol=1e-12,
                                   atol=1e-12, equal_nan=True)
    if case == "one_cell":
        assert torch.count_nonzero(ref[0].abs().sum(-1)) == 4


@pytest.mark.parametrize("c,max_vec,want", [
    (3, 4, (0, 1)), (1, 2, (0, 1)), (32, 4, (4, 8)), (64, 4, (4, 16)),
    (96, 4, (4, 32)), (128, 4, (4, 32)), (196, 4, (4, 32)), (32, 2, (2, 16)),
    (6, 4, (2, 1)), (10, 4, (2, 2)), (17, 4, (1, 4))])
def test_warp_bwd_plan_covers_every_channel_once(c, max_vec, want):
    """The kernel's plan (V channels per lane and step, lanes per sample)
    at the channel counts the warps give (PWCNet 32–128, FlowNet2's
    3-channel images on the narrow kernel, PWCNet's 196 and odd widths),
    and the channels its lanes visit (lane·V, then strides of lanes·V)
    cover [0, C) once."""
    vec, lanes = sg._plan(c, max_vec)
    assert (vec, lanes) == want
    if vec == 0:  # the narrow kernel: a thread per sample, C < 4
        return
    assert c % vec == 0 and vec <= max_vec and lanes & (lanes - 1) == 0
    seen = [ch + j for lane in range(lanes)
            for ch in range(lane * vec, c, lanes * vec) for j in range(vec)]
    assert sorted(seen) == list(range(c))
