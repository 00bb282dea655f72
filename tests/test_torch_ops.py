"""`pcfa_tpu_torch` ops, padder and config knobs vs `pcfa_tpu` on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the ops here are the same float32 arithmetic in both packages
(sums of at most a few hundred terms), so they agree to ~1e-6; 1e-5 leaves
room for a different summation order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcfa_tpu.ops import correlation as jcorr
from pcfa_tpu.ops import warp as jwarp
from pcfa_tpu.utils.padder import InputPadder as JInputPadder
from pcfa_tpu_torch import _device, config
from pcfa_tpu_torch.ops import correlation, warp
from pcfa_tpu_torch.utils.padder import InputPadder

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
