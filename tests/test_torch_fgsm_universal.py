"""`pcfa_tpu_torch.attack.fgsm` and `.universal` vs `pcfa_tpu`'s on the
CPU, in float64, at 1e-9: I-FGSM (disjoint and joint) on 2 pairs against
the JAX attack vmapped over the pairs, and the universal attack over two
batches with the L-BFGS state carried from the first to the second.

The net is a small float64 map written in both packages: a 3×3 conv of
the stacked pair (6 → 2 channels) plus a bias, through tanh, so every
flow pixel depends on a neighbourhood of both frames. Frames are uint8 /
255 with saturated patches, so the clips meet their bounds. The δ norms
`l2_delta1` and `l2_delta2` are float32 sums in both packages and agree
to 1e-6.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pcfa_tpu.attack import fgsm as jfgsm
from pcfa_tpu.attack import lbfgs as jlbfgs
from pcfa_tpu.attack import universal as juniversal
from pcfa_tpu_torch.attack import fgsm, lbfgs, universal

H, W = 8, 12


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


def _frames(rng, shape):
    x = np.round(rng.random(shape) * 255.0) / 255.0
    x[..., :2, :3, :] = 0.0
    x[..., 2:4, 3:5, :] = 1.0
    return x


def _nets(rng):
    """(torch flow_fn, JAX flow_fn) of the same float64 map, (B, H, W, 3)
    pairs → (B, H, W, 2)."""
    k = 0.5 * rng.standard_normal((3, 3, 6, 2))  # HWIO
    bias = np.array([0.3, -0.2])
    kt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))

    def tflow(a, b):
        x = torch.cat([a, b], -1).permute(0, 3, 1, 2)
        y = F.conv2d(x, kt, padding=1).permute(0, 2, 3, 1)
        return torch.tanh(y + torch.from_numpy(bias))

    def jflow(a, b):
        y = jax.lax.conv_general_dilated(
            jnp.concatenate([a, b], -1), k, (1, 1), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jnp.tanh(y + bias)

    return tflow, jflow


def _close(got, want, name):
    """1e-9; `two_norm_avg` sums in float32 in both packages, so its
    float32 values agree to float32 summation order (1e-6)."""
    got, want = np.asarray(got), np.asarray(want)
    tol = 1e-6 if got.dtype == np.float32 else 1e-9
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("joint", [False, True])
def test_fgsm_matches_jax(joint):
    """2 pairs, 3 steps of ε = 0.01: metrics (B, steps), final δs, the
    initial and last flows."""
    rng = np.random.default_rng(0)
    tflow, jflow = _nets(rng)
    i1, i2 = _frames(rng, (2, H, W, 3)), _frames(rng, (2, H, W, 3))
    tgt = 0.1 * rng.standard_normal((2, H, W, 2))
    kw = dict(steps=3, epsilon=0.01, joint_perturbation=joint)
    res = fgsm.fgsm_attack(tflow, *(torch.from_numpy(a) for a in (i1, i2,
                                                                  tgt)),
                           fgsm.FGSMConfig(**kw), device="cpu")
    with jax.enable_x64(True):
        jres = jax.jit(jax.vmap(lambda a, b, t: jfgsm.fgsm_attack(
            jflow, a, b, t, jfgsm.FGSMConfig(**kw))))(
                *(jnp.asarray(a[:, None]) for a in (i1, i2, tgt)))
        jres = jax.tree.map(np.asarray, jres)
    for name in fgsm.FGSMMetrics._fields:
        got = getattr(res.metrics, name)
        assert got.shape == (2, 3), name
        _close(got, getattr(jres.metrics, name), name)
    for name in ("delta1", "delta2", "flow_pred_init", "flow_pred"):
        _close(getattr(res, name), getattr(jres, name)[:, 0], name)
    # every step moved each pixel by ε or was clipped at a bound
    d = res.delta1.numpy()
    assert np.abs(d).max() > 0.02
    x1 = i1 + d
    assert x1.min() >= 0.0 and x1.max() <= 1.0


@pytest.mark.parametrize("direction,joint", [("two_loop", False),
                                             ("compact", True)])
def test_universal_matches_jax_across_batches(direction, joint):
    """One δ for two batches of 2 pairs each, 2 steps × max_iter 3 per
    batch, history 5: the state carried from the first batch to the
    second, both packages in float64. Per batch the metrics (steps,),
    the flows, and the state after it: x, history count, Gram rows."""
    rng = np.random.default_rng(1)
    tflow, jflow = _nets(rng)
    batches = [[_frames(rng, (2, H, W, 3)) for _ in range(2)]
               for _ in range(2)]
    tgt = np.zeros((2, H, W, 2))
    kw = dict(steps=2, max_iter=3, history_size=5, lbfgs_direction=direction,
              joint_perturbation=joint)
    cfg, jcfg = universal.UniversalConfig(**kw), juniversal.UniversalConfig(
        **kw)
    n = H * W * 3 * (1 if joint else 2)
    # a float64 state (`universal_init`'s is float32, as the JAX package's)
    state = lbfgs.lbfgs_init(torch.zeros((1, n), dtype=torch.float64), 5)
    with jax.enable_x64(True):
        jstate = jlbfgs.lbfgs_init(jnp.zeros((n,), jnp.float64), 5)
        for i1, i2 in batches:
            state, metrics, init, pred = universal.universal_batch_attack(
                tflow, torch.from_numpy(i1), torch.from_numpy(i2),
                torch.from_numpy(tgt), state, cfg)
            jstate, jmetrics, jinit, jpred = juniversal.universal_batch_attack(
                jflow, jnp.asarray(i1), jnp.asarray(i2), jnp.asarray(tgt),
                jstate, jcfg)
            for name in universal.UniversalMetrics._fields:
                got = getattr(metrics, name)
                assert got.shape == (2,), name
                _close(got, getattr(jmetrics, name), name)
            _close(init, jinit, "flow_pred_init")
            _close(pred, jpred, "flow_pred")
            _close(state.x[0], jstate.x, "x")
            assert int(state.count[0]) == int(jstate.count)
            if direction == "compact":
                _close(state.gram_sy[0], jstate.gram_sy, "gram_sy")
    assert int(state.count[0]) > 3  # the history grew across the batches
    d1, d2 = universal.unpack_deltas(state.x[0], (H, W, 3), joint)
    assert d1.shape == (H, W, 3) and float(d1.abs().max()) > 0
    assert (d1 is d2) == joint


def test_universal_init_matches_jax():
    """δ = 0, a float32 variable of δ1 then δ2 (δ once in joint mode), as
    `pcfa_tpu`'s; a bf16 history where asked."""
    for joint in (False, True):
        cfg = universal.UniversalConfig(history_size=4,
                                        joint_perturbation=joint,
                                        lbfgs_history_dtype="bfloat16")
        s = universal.universal_init((5, 6, 3), cfg, device="cpu")
        js = juniversal.universal_init((5, 6, 3),
                                       juniversal.UniversalConfig(
                                           history_size=4,
                                           joint_perturbation=joint,
                                           lbfgs_history_dtype="bfloat16"))
        assert s.x.shape == (1, js.x.shape[0]) and s.x.dtype == torch.float32
        assert not s.x.any()
        assert s.y_buf.shape == (1, *js.y_buf.shape)
        assert s.y_buf.dtype == torch.bfloat16
