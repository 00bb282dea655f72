"""`pcfa_tpu_torch` ops, padder and config knobs vs `pcfa_tpu` on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the ops here are the same float32 arithmetic in both packages
(sums of at most a few hundred terms), so they agree to ~1e-6; 1e-5 leaves
room for a different summation order.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from pcfa_tpu.ops import correlation as jcorr
from pcfa_tpu.ops import warp as jwarp
from pcfa_tpu.utils.padder import InputPadder as JInputPadder
from pcfa_tpu_torch import _device, config
from pcfa_tpu_torch.ops import correlation, warp
from pcfa_tpu_torch.utils.padder import InputPadder


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


TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_coords_grid_matches_jax():
    got = warp.coords_grid(2, 5, 7, device="cpu")
    ref = np.asarray(jwarp.coords_grid(2, 5, 7))
    assert got.dtype == torch.float32 and got.shape == (2, 5, 7, 2)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("hw", [(12, 16), (47, 13)])  # 47 → 23: floor
def test_avg_pool2d_matches_jax(rng, hw):
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    got = warp.avg_pool2d(_t(x), 2, 2)
    ref = np.asarray(jwarp.avg_pool2d(jnp.asarray(x), 2, 2))
    assert got.shape == ref.shape == (2, hw[0] // 2, hw[1] // 2, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL)


def test_bilinear_sampler_matches_jax(rng):
    img = rng.standard_normal((3, 9, 11, 2)).astype(np.float32)
    # in-map, on-grid, border and out-of-map points
    pts = rng.uniform(-3, 13, (3, 4, 5, 2)).astype(np.float32)
    pts[0, 0, 0] = (0.0, 0.0)
    pts[0, 0, 1] = (10.0, 8.0)
    pts[0, 0, 2] = (-20.0, 40.0)
    got = warp.bilinear_sampler(_t(img), _t(pts))
    ref = np.asarray(jwarp.bilinear_sampler(jnp.asarray(img),
                                            jnp.asarray(pts)))
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL)


def test_corr_pyramid_pooled_matches_jax(rng):
    """Values and the gradients with respect to both feature maps."""
    f1 = rng.standard_normal((2, 6, 8, 16)).astype(np.float32)
    f2 = rng.standard_normal((2, 11, 13, 16)).astype(np.float32)  # odd sizes
    ref = jcorr.corr_pyramid_pooled(jnp.asarray(f1), jnp.asarray(f2), 3)
    t1, t2 = _t(f1).requires_grad_(True), _t(f2).requires_grad_(True)
    got = correlation.corr_pyramid_pooled(t1, t2, 3)
    assert [tuple(g.shape) for g in got] == [(96, 11, 13), (96, 5, 6),
                                              (96, 2, 3)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(),
                                   np.asarray(r)[..., 0], atol=TOL)

    import jax

    cot = [rng.standard_normal(np.asarray(r).shape).astype(np.float32)
           for r in ref]
    j1, j2 = jax.grad(
        lambda a, b: sum(jnp.sum(lv * c) for lv, c in zip(
            jcorr.corr_pyramid_pooled(a, b, 3), cot)),
        argnums=(0, 1))(jnp.asarray(f1), jnp.asarray(f2))
    sum((lv * _t(c)[..., 0]).sum() for lv, c in zip(got, cot)).backward()
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(j1), atol=1e-4)
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(j2), atol=1e-4)


@pytest.mark.parametrize("shape", [
    ((2, 47, 156, 256), "float32"),     # KITTI /8, B = 2: materialized
    ((1, 94, 312, 256), "bfloat16"),    # 2× KITTI, B = 1: materialized
    ((2, 94, 312, 256), "bfloat16"),    # 2× KITTI, B = 2: fused
])
def test_resolve_corr_impl_matches_jax(shape):
    fshape, dt = shape
    ref = jcorr.resolve_corr_impl("auto", fshape, fshape, 4, getattr(jnp, dt))
    if ref == "materialized":
        assert correlation.resolve_corr_impl(
            "auto", fshape, fshape, 4, getattr(torch, dt)) == ref
    else:
        with pytest.raises(NotImplementedError, match="later slice"):
            correlation.resolve_corr_impl("auto", fshape, fshape, 4,
                                          getattr(torch, dt))


def test_resolve_corr_impl_budget_knob(monkeypatch):
    shape = (2, 47, 156, 256)
    monkeypatch.setenv("PCFA_CORR_HBM_BUDGET_MB", "1")
    assert jcorr.resolve_corr_impl("auto", shape, shape, 4,
                                   jnp.bfloat16) == "fused"
    with pytest.raises(NotImplementedError):
        correlation.resolve_corr_impl("auto", shape, shape, 4, torch.bfloat16)
    with pytest.raises(NotImplementedError):
        correlation.resolve_corr_impl("hybrid", shape, shape, 4,
                                      torch.float32)


@pytest.mark.parametrize("hw,mode", [((375, 1242), "kitti"),
                                     ((436, 1024), "sintel"),
                                     ((33, 17), "sintel")])
def test_padder_matches_jax(rng, hw, mode):
    x = rng.random((2, *hw, 3)).astype(np.float32)
    jp = JInputPadder(x.shape, divisor=8, mode=mode)
    tp = InputPadder(x.shape, divisor=8, mode=mode)
    assert tp.padded_shape == jp.padded_shape
    (got,) = tp.pad(_t(x))
    (ref,) = jp.pad(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    (got_np,) = tp.pad(x)
    np.testing.assert_array_equal(got_np, np.asarray(ref))
    np.testing.assert_array_equal(tp.unpad(got).numpy(), x)


def test_config_knobs_match_jax(monkeypatch):
    from pcfa_tpu import config as jconfig

    for env in ("", "two_loop"):
        monkeypatch.setenv("PCFA_LBFGS_DIRECTION", env or "compact")
        assert config.lbfgs_direction() == jconfig.lbfgs_direction()
    monkeypatch.setenv("PCFA_LBFGS_DTYPE", "bfloat16")
    assert config.lbfgs_history_dtype("RAFT") == "bfloat16"
    for mod in (config, jconfig):
        with pytest.raises(ValueError, match="PWCNet"):
            mod.lbfgs_history_dtype("PWCNet")
    monkeypatch.setenv("PCFA_LBFGS_DTYPE_FORCE", "1")
    with pytest.warns(UserWarning):
        assert config.lbfgs_history_dtype("PWCNet") == "bfloat16"
    monkeypatch.setenv("PCFA_LBFGS_DTYPE", "float32")
    assert config.lbfgs_history_dtype("RAFT") is None
    monkeypatch.setenv("PCFA_COMPUTE_DTYPE", "bfloat16")
    assert config.compute_dtype() is torch.bfloat16
    monkeypatch.setenv("PCFA_COMPUTE_DTYPE", "float32")
    assert config.compute_dtype() is None
    monkeypatch.setenv("PCFA_COMPUTE_DTYPE", "int8")
    with pytest.raises(ValueError):
        config.compute_dtype()


def test_resolve_device_needs_cuda_unless_cpu():
    assert _device.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert _device.resolve_device().type == "cuda"
        assert not torch.backends.cudnn.allow_tf32
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _device.resolve_device()
    with pytest.raises(ValueError):
        _device.resolve_device("meta")


# ------------------------------------------- packed sampler, PWC warp ---

def _jax_onehot_segsum(monkeypatch):
    """Route the JAX warp VJP's image gradient through the Pallas segsum
    kernel in interpret mode, as tests/test_ops_warp.py does."""
    from pcfa_tpu.ops.pallas import segsum as jsegsum

    monkeypatch.setattr(jsegsum, "_INTERPRET", True)
    monkeypatch.setenv("PCFA_WARP_DIMG", "onehot")


@pytest.mark.parametrize("mode,align", [("zeros", False), ("zeros", True),
                                        ("border", False)])
def test_grid_sample_matches_jax(rng, monkeypatch, mode, align):
    """Values, d img and d grid of the packed-corner sampler against
    `pcfa_tpu`'s (its custom VJP, d img through the Pallas segsum), with
    coordinates in, on the edge of, and far outside the image, and a
    collision hotspot. float32: 1e-5 on values, 2e-5 on d img (sums of
    many corner rows), 1e-4 on d grid (scaled by W/2)."""
    import jax

    _jax_onehot_segsum(monkeypatch)
    img = rng.standard_normal((2, 9, 12, 3)).astype(np.float32)
    grid = rng.uniform(-1.6, 1.6, (2, 7, 10, 2)).astype(np.float32)
    grid[0, :3, :3] = (0.21, -0.37)           # many samples on one window
    grid[1, 0, 0] = (-1.0, 1.0)               # exact corners
    grid[1, 0, 1] = (40.0, -50.0)             # far outside
    g = rng.standard_normal((2, 7, 10, 3)).astype(np.float32)

    ti = _t(img).requires_grad_(True)
    tg = _t(grid).requires_grad_(True)
    out = warp.grid_sample(ti, tg, align, mode)
    (out * _t(g)).sum().backward()

    def f(a, b):
        return jwarp.grid_sample(a, b, align_corners=align, padding_mode=mode)

    ref, vjp = jax.vjp(f, jnp.asarray(img), jnp.asarray(grid))
    di, dg = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=TOL)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(di), atol=2e-5)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(dg), atol=1e-4)


def test_grid_sample_matches_torch(rng):
    """The packed sampler equals `F.grid_sample` (values), both padding
    modes, including a NaN coordinate (zeros mode: 0, like the JAX
    sampler's masked weights)."""
    img = rng.standard_normal((1, 6, 8, 2)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (1, 5, 4, 2)).astype(np.float32)
    for mode in ("zeros", "border"):
        ref = F.grid_sample(_t(img).permute(0, 3, 1, 2), _t(grid),
                            mode="bilinear", padding_mode=mode,
                            align_corners=False).permute(0, 2, 3, 1)
        np.testing.assert_allclose(
            warp.grid_sample(_t(img), _t(grid), False, mode).numpy(),
            ref.numpy(), atol=TOL)
    grid[0, 0, 0] = np.nan
    out = warp.grid_sample(_t(img), _t(grid), False, "zeros")
    assert torch.count_nonzero(out[0, 0, 0]) == 0


def test_pwc_warp_matches_jax(rng, monkeypatch):
    """`pwc_warp` (grid normalized by max(W−1, 1), sampled with
    align_corners=False and zero padding, mask `grid_sample(ones) ≥ 1e-4`
    without gradient): values and the gradients of x and flow, with flows
    that push samples off the map."""
    import jax

    from pcfa_tpu.models.pwcnet import pwc_warp as jpwc_warp
    from pcfa_tpu_torch.models.pwcnet import pwc_warp

    _jax_onehot_segsum(monkeypatch)
    x = rng.standard_normal((2, 8, 10, 5)).astype(np.float32)
    flow = (3.0 * rng.standard_normal((2, 8, 10, 2))).astype(np.float32)
    flow[0, 0, 0] = (-30.0, 2.0)
    g = rng.standard_normal((2, 8, 10, 5)).astype(np.float32)
    tx, tf = _t(x).requires_grad_(True), _t(flow).requires_grad_(True)
    out = pwc_warp(tx, tf)
    (out * _t(g)).sum().backward()
    ref, vjp = jax.vjp(jpwc_warp, jnp.asarray(x), jnp.asarray(flow))
    dx, df = vjp(jnp.asarray(g))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=TOL)
    assert torch.count_nonzero(out[0, 0, 0]) == 0  # masked off the map
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), atol=2e-5)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(df), atol=1e-4)
    # bf16 features keep a float32 grid and come back bf16
    out16 = pwc_warp(_t(x).bfloat16(), _t(flow))
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(), np.asarray(ref),
                               atol=5e-2)


@pytest.mark.parametrize("align", [False, True])
def test_interpolate_bilinear_matches_jax_and_torch(rng, align):
    x = rng.standard_normal((2, 5, 7, 2)).astype(np.float32)
    got = warp.interpolate_bilinear(_t(x), (20, 28), align)
    ref = np.asarray(jwarp.interpolate_bilinear(jnp.asarray(x), (20, 28),
                                                align))
    assert got.shape == (2, 20, 28, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL)
    direct = F.interpolate(_t(x).permute(0, 3, 1, 2), size=(20, 28),
                           mode="bilinear", align_corners=align)
    np.testing.assert_allclose(got.numpy(),
                               direct.permute(0, 2, 3, 1).numpy(), atol=1e-6)
    assert warp.interpolate_bilinear(_t(x).bfloat16(), (20, 28)).dtype \
        == torch.float32
