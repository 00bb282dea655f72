"""`pcfa_tpu_torch.attack` vs `pcfa_tpu.attack` on the CPU: losses, box
constraints, targets, the L-BFGS trajectories with a leading pair axis, and
a small PCFA attack on RAFT end to end. Also proves that the port imports
nothing of JAX.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcfa_tpu.attack import boxconstraint as jbc
from pcfa_tpu.attack import lbfgs as jlbfgs
from pcfa_tpu.attack import losses as jlosses
from pcfa_tpu.attack import pcfa as jpcfa
from pcfa_tpu.attack import targets as jtargets
from pcfa_tpu.models import make_model as jmake_model
from pcfa_tpu_torch.attack import boxconstraint as bc
from pcfa_tpu_torch.attack import lbfgs, losses, pcfa, targets
from pcfa_tpu_torch.models import make_model
from pcfa_tpu_torch.models.convert import raft_params_from_jax


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


REPO = Path(__file__).resolve().parent.parent


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("f_type", ["aee", "mse", "cosim"])
def test_losses_match_jax(rng, f_type):
    pred = rng.standard_normal((6, 7, 2)).astype(np.float32)
    tgt = rng.standard_normal((6, 7, 2)).astype(np.float32)
    d1 = (rng.standard_normal((6, 7, 3)) * 0.01).astype(np.float32)
    d2 = (rng.standard_normal((6, 7, 3)) * 0.01).astype(np.float32)
    got = losses.loss_delta_constraint(_t(pred), _t(tgt), _t(d1), _t(d2),
                                       0.005, 123.0, f_type)
    ref = jlosses.loss_delta_constraint(jnp.asarray(pred), jnp.asarray(tgt),
                                        jnp.asarray(d1), jnp.asarray(d2),
                                        0.005, 123.0, f_type)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    for name in ("two_norm_avg_delta", "two_norm_avg_delta_squared"):
        np.testing.assert_allclose(
            float(getattr(losses, name)(_t(d1), _t(d2))),
            float(getattr(jlosses, name)(jnp.asarray(d1), jnp.asarray(d2))),
            rtol=1e-5)
    for tgt_name in ("zero", "neg_flow"):
        assert losses.default_mu(0.005, tgt_name) == jlosses.default_mu(
            0.005, tgt_name)


@pytest.mark.parametrize("box", ["clipping", "change_of_variables"])
def test_boxconstraint_matches_jax(rng, box):
    i1 = rng.random((5, 6, 3)).astype(np.float32)
    i2 = rng.random((5, 6, 3)).astype(np.float32)
    n1 = (i1 + rng.standard_normal(i1.shape) * 0.3).astype(np.float32)
    n2 = (i2 + rng.standard_normal(i2.shape) * 0.3).astype(np.float32)
    got = [*bc.init_nw_inputs(_t(i1), _t(i2), box),
           *bc.perturbed_images(_t(n1), _t(n2), box),
           *bc.extract_deltas(_t(n1), _t(n2), _t(i1), _t(i2), box, 1e-7)]
    j = [jnp.asarray(a) for a in (i1, i2, n1, n2)]
    ref = [*jbc.init_nw_inputs(j[0], j[1], box),
           *jbc.perturbed_images(j[2], j[3], box),
           *jbc.extract_deltas(j[2], j[3], j[0], j[1], box, 1e-7)]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)
    np.testing.assert_allclose(
        bc.extract_deltas_joint(_t(n1 - i1), _t(np.maximum(i1, i2)),
                                _t(np.minimum(i1, i2)))[0].numpy(),
        np.asarray(jbc.extract_deltas_joint(
            j[2] - j[0], jnp.maximum(j[0], j[1]),
            jnp.minimum(j[0], j[1]))[0]), atol=1e-6)


def _frames(rng, shape):
    """float64 frames as real ones are, uint8 / 255, with exact 0s and 1s
    (a saturated patch of each)."""
    x = np.round(rng.random(shape) * 255.0) / 255.0
    x[..., :2, :3, :] = 0.0
    x[..., 2:4, 3:5, :] = 1.0
    return x


def test_clip_derivative_on_a_bound_matches_jnp_clip(rng):
    """The box clips' gradients where their argument lies exactly on 0 or
    1: ½ there, as `jnp.clip` gives (max then min; `torch.clamp` would
    give 1), in `perturbed_images`, `extract_deltas` and both clips of
    `extract_deltas_joint`, against JAX in float64."""
    i1, i2 = _frames(rng, (6, 7, 3)), _frames(rng, (6, 7, 3))
    w1, w2 = rng.standard_normal((2, 6, 7, 3))
    i_max, i_min = np.maximum(i1, i2), np.minimum(i1, i2)
    cases = {
        "perturbed_images": (
            lambda x: bc.perturbed_images(x, x, "clipping"),
            lambda x: jbc.perturbed_images(x, x, "clipping"), i1),
        "extract_deltas": (
            lambda x: bc.extract_deltas(x, x, torch.from_numpy(i1),
                                        torch.from_numpy(i2), "clipping"),
            lambda x: jbc.extract_deltas(x, x, i1, i2, "clipping"), i2),
        "extract_deltas_joint": (
            lambda x: bc.extract_deltas_joint(x, torch.from_numpy(i_max),
                                              torch.from_numpy(i_min)),
            lambda x: jbc.extract_deltas_joint(x, i_max, i_min),
            np.zeros_like(i1)),
    }
    for name, (port, ref, x) in cases.items():
        t = torch.from_numpy(x).requires_grad_(True)
        a, b = port(t)
        (a * torch.from_numpy(w1) + b * torch.from_numpy(w2)).sum().backward()
        with jax.enable_x64(True):
            want = np.asarray(jax.grad(lambda v: jnp.sum(
                ref(v)[0] * w1 + ref(v)[1] * w2))(jnp.asarray(x)))
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    # the bound is met, and there the derivative is ½
    t = torch.tensor([0.0, 0.3, 1.0], dtype=torch.float64, requires_grad=True)
    bc.clip01(t).sum().backward()
    assert t.grad.tolist() == [0.5, 1.0, 0.5]


def test_penalty_derivative_at_the_bound_matches_jnp_maximum():
    """δ filled with 0.5 and bound 0.5 make ‖δ‖²_avg equal bound² exactly
    in float64: there the penalty's gradient is ½·∂‖δ‖²_avg, as
    `jax.grad` of the JAX package's `jnp.maximum(0, …)` gives (a clamp
    at 0 gave the full value), and the penalty itself is 0."""
    d1, d2 = np.full((2, 3, 4, 3), 0.5), np.full((2, 3, 4, 3), 0.5)
    t1, t2 = (torch.from_numpy(d).requires_grad_(True) for d in (d1, d2))
    pen = losses.relu_penalty(t1, t2, 0.5)
    pen.backward()
    with jax.enable_x64(True):
        want = jax.grad(lambda a, b: jlosses.relu_penalty(a, b, 0.5),
                        argnums=(0, 1))(jnp.asarray(d1), jnp.asarray(d2))
    assert float(pen) == 0.0
    full = 2 * d1 / (d1.size + d2.size)      # ∂‖δ‖²_avg / ∂δ1
    for got, ref in zip((t1.grad, t2.grad), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got.numpy(), 0.5 * full)


def test_aee_derivative_where_the_flow_meets_the_target_is_zero(rng):
    """Where a pixel's endpoint difference is exactly 0 the AEE's
    derivative is 0, as `torch.linalg.vector_norm`'s (the square root's
    is ∞ there, and ∞ · 0 made it NaN); the value is sqrt(Σ Δ²)'s bit for
    bit, the derivative elsewhere the square root's bit for bit and the
    JAX package's to float32 rounding, and a NaN flow stays NaN."""
    pred = rng.standard_normal((2, 9, 11, 2)).astype(np.float32)
    tgt = rng.standard_normal((2, 9, 11, 2)).astype(np.float32)
    pred[0, 3, 4] = tgt[0, 3, 4]
    pred[1, 8, 0] = tgt[1, 8, 0]
    met = np.zeros((2, 9, 11, 2), bool)
    met[0, 3, 4] = met[1, 8, 0] = True

    def value_and_grad(fn):
        p = _t(pred).requires_grad_(True)
        v = fn(p, _t(tgt))
        v.backward()
        return v.detach(), p.grad

    def sqrt_aee(a, b):
        return torch.sqrt(torch.sum((a - b) ** 2, dim=-1)).mean()

    v, g = value_and_grad(losses.avg_epe)
    v_sqrt, g_sqrt = value_and_grad(sqrt_aee)
    assert torch.equal(v, v_sqrt)
    assert bool(torch.isnan(g_sqrt[torch.from_numpy(met)]).all())
    assert bool(torch.isfinite(g).all())
    assert not bool(g[torch.from_numpy(met)].any())
    assert torch.equal(g[torch.from_numpy(~met)], g_sqrt[torch.from_numpy(
        ~met)])
    want = jax.grad(jlosses.avg_epe)(jnp.asarray(pred), jnp.asarray(tgt))
    np.testing.assert_allclose(g.numpy()[~met], np.asarray(want)[~met],
                               rtol=1e-6, atol=1e-9)
    bad = pred.copy()
    bad[1, 2, 2, 0] = np.nan
    assert bool(torch.isnan(losses.avg_epe(_t(bad), _t(tgt))))


def test_pcfa_stays_finite_where_the_flow_meets_the_target_exactly():
    """A flow that meets the zero target exactly at one pixel whatever the
    frames (the network's output is multiplied by 0 there): the closures'
    gradients and every iterate of three compact L-BFGS iterations stay
    finite, the attack moves, and the pixel's inputs get no gradient from
    it."""
    gen = torch.Generator().manual_seed(5)
    x1, x2 = (torch.rand((1, 8, 8, 3), generator=gen) for _ in range(2))
    keep = torch.ones((1, 8, 8, 1))
    keep[0, 2, 5] = 0.0

    def flow_fn(a, b):
        return (a - 0.5 * b)[..., :2] * keep

    cfg = pcfa.PCFAConfig(steps=1, max_iter=3, delta_bound=0.05,
                          boxconstraint="change_of_variables",
                          lbfgs_direction="compact")
    state, init = pcfa.pcfa_init(flow_fn, x1, x2, cfg, "cpu")
    assert float(init[0, 2, 5].abs().sum()) == 0.0
    _, _, _, value_and_grad = pcfa._make_problem(
        flow_fn, x1, x2, torch.zeros((1, 8, 8, 2)), cfg)
    loss, grad = value_and_grad(state.opt.x)
    assert bool(torch.isfinite(loss).all() & torch.isfinite(grad).all())
    state, metrics, _ = pcfa.pcfa_outer_step(
        flow_fn, x1, x2, torch.zeros((1, 8, 8, 2)), init, state, cfg)
    assert int(state.opt.n_iter[0]) == 3
    assert bool(torch.isfinite(state.opt.x).all())
    assert bool(torch.isfinite(metrics.aee_adv_tgt).all())
    assert not torch.equal(state.opt.x, pcfa._make_problem(
        flow_fn, x1, x2, None, cfg)[0])


@pytest.mark.parametrize("joint", [False, True])
def test_first_pcfa_closure_gradient_matches_jax_on_saturated_frames(
        rng, joint):
    """The first closure (at δ = 0, so at the images) on frames with exact
    0 and 1 pixels: loss and gradient of the port's `_make_problem`
    against the JAX package's, float64, 1e-12, disjoint clipping and
    joint. The net is a smooth float64 map written in both packages."""
    i1, i2 = _frames(rng, (1, 8, 10, 3)), _frames(rng, (1, 8, 10, 3))
    mix = rng.standard_normal((6, 2))

    def tflow(a, b):
        return torch.tanh(torch.cat([a, b], -1) @ torch.from_numpy(mix)
                          + 0.3)

    def jflow(a, b):
        return jnp.tanh(jnp.concatenate([a, b], -1) @ mix + 0.3)

    kw = dict(steps=1, max_iter=1, joint_perturbation=joint)
    x0, _, _, vg = pcfa._make_problem(
        tflow, torch.from_numpy(i1), torch.from_numpy(i2),
        torch.zeros((1, 8, 10, 2), dtype=torch.float64),
        pcfa.PCFAConfig(**kw))
    loss, grad = vg(x0)
    with jax.enable_x64(True):
        jx0, _, _, jvg = jpcfa._make_problem(
            jflow, jnp.asarray(i1), jnp.asarray(i2),
            jnp.zeros((1, 8, 10, 2)), jpcfa.PCFAConfig(**kw))
        jloss, jgrad = jvg(jx0)
        jloss, jgrad = float(jloss), np.asarray(jgrad)
    np.testing.assert_allclose(float(loss[0]), jloss, rtol=1e-12)
    np.testing.assert_allclose(grad[0].numpy(), jgrad, rtol=1e-12,
                               atol=1e-12)
    saturated = np.concatenate([i1.ravel(), i2.ravel()])
    if joint:
        saturated = i1.ravel()
    edge = (saturated == 0.0) | (saturated == 1.0)
    assert edge.any() and np.abs(jgrad[edge]).max() > 1e-3


def test_targets_match_jax(rng):
    flow = rng.standard_normal((4, 5, 2)).astype(np.float32)
    for name in ("zero", "neg_flow"):
        np.testing.assert_array_equal(
            targets.make_target_fn(name)(_t(flow)).numpy(),
            np.asarray(jtargets.make_target_fn(name)(jnp.asarray(flow))))
    tgt = rng.standard_normal((7, 9, 2)).astype(np.float32)
    for hw in ((5, 12), (10, 4)):
        np.testing.assert_array_equal(targets.fit_custom_target(tgt, *hw),
                                      jtargets.fit_custom_target(tgt, *hw))
    with pytest.raises(ValueError):
        targets.make_target_fn("nope")


# ------------------------------------------------------------- L-BFGS ---

def _quadratics(rng, n=12):
    """Pair 0 is well conditioned (A = 2I): L-BFGS solves it in two
    iterations, then its gradient vanishes and its `done` latch sets at
    every segment entry. Pair 1 is ill conditioned and keeps iterating."""
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a1 = (q * np.logspace(0, 2, n)) @ q.T
    mats = np.stack([2.0 * np.eye(n), a1]).astype(np.float32)
    vecs = rng.standard_normal((2, n)).astype(np.float32)
    x0 = rng.standard_normal((2, n)).astype(np.float32)
    return mats, vecs, x0


def _port_vg(mats, vecs):
    A, b = _t(mats), _t(vecs)

    def vg(x):
        ax = torch.einsum("bij,bj->bi", A, x)
        return 0.5 * (x * ax).sum(1) - (b * x).sum(1), ax - b

    return vg


def _jax_vg(a, b):
    a, b = jnp.asarray(a), jnp.asarray(b)
    return jax.value_and_grad(lambda x: 0.5 * x @ a @ x - b @ x)


@pytest.mark.parametrize("direction", ["two_loop", "compact"])
def test_lbfgs_pairs_match_jax_lbfgs_run(rng, direction):
    """B = 2 problems at once (different done latches) follow exactly the
    single-problem trajectories of JAX `lbfgs_run`: the same per-iteration
    losses and final x. float32 on O(10) values: atol 1e-4."""
    mats, vecs, x0 = _quadratics(rng)
    steps, max_iter, hist = 4, 5, 4  # history 4 < 20 pushes: the ring wraps
    x_fin, loss_traj = lbfgs.lbfgs_run(_port_vg(mats, vecs), _t(x0), steps,
                                       max_iter, hist, direction=direction)
    assert loss_traj.shape == (2, steps * max_iter)
    for p in range(2):
        jx, jl = jlbfgs.lbfgs_run(_jax_vg(mats[p], vecs[p]),
                                  jnp.asarray(x0[p]), steps, max_iter, hist,
                                  direction=direction)
        np.testing.assert_allclose(loss_traj[p].numpy(), np.asarray(jl),
                                   atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(x_fin[p].numpy(), np.asarray(jx),
                                   atol=1e-4)
    # the latches differed: pair 0 stopped moving long before pair 1
    assert float(loss_traj[0, 3:].std()) < 1e-6 < float(loss_traj[1, 3:].std())


def test_lbfgs_state_masks_done_pair(rng):
    """A pair whose latch is set keeps its history, count and iterate while
    the other pair moves on."""
    mats, vecs, x0 = _quadratics(rng)
    state = lbfgs.lbfgs_init(_t(x0), 5)
    vg = _port_vg(mats, vecs)
    for pos in range(4):
        state, _ = lbfgs.lbfgs_iteration(vg, state, pos, direction="compact")
    assert bool(state.done[0]) and not bool(state.done[1])
    before = state
    state, _ = lbfgs.lbfgs_iteration(vg, state, 4, direction="compact")
    assert torch.equal(state.x[0], before.x[0])
    assert int(state.n_iter[0]) == int(before.n_iter[0])
    assert int(state.n_iter[1]) == int(before.n_iter[1]) + 1


def test_lbfgs_bf16_history_matches_jax(rng):
    """Compact direction with a bf16 history (the bench's setting): both
    packages round y and s to bf16 and accumulate in float32, so the
    trajectories agree to float32 rounding amplified by the solve."""
    mats, vecs, x0 = _quadratics(rng)
    steps, max_iter, hist = 2, 5, 6
    state = lbfgs.lbfgs_init(_t(x0), hist, "bfloat16")
    assert state.y_buf.dtype == torch.bfloat16
    vg = _port_vg(mats, vecs)
    losses_p = []
    for _ in range(steps):
        for pos in range(max_iter):
            state, loss = lbfgs.lbfgs_iteration(vg, state, pos,
                                                direction="compact")
            losses_p.append(loss)
    losses_p = torch.stack(losses_p, 1)
    for p in range(2):
        vgj = _jax_vg(mats[p], vecs[p])
        it = jax.jit(lambda s, pos: jlbfgs.lbfgs_iteration(
            vgj, s, pos, direction="compact"))
        s = jlbfgs.lbfgs_init(jnp.asarray(x0[p]), hist, jnp.bfloat16)
        jl = []
        for _ in range(steps):
            for pos in range(max_iter):
                s, loss = it(s, jnp.asarray(pos, jnp.int32))
                jl.append(float(loss))
        np.testing.assert_allclose(losses_p[p].numpy(), jl, rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(state.x[p].numpy(), np.asarray(s.x),
                                   atol=1e-3)


# --------------------------------------------------- PCFA end to end ---

H = W = 128


@pytest.fixture(scope="module")
def raft_models():
    jmodel, _ = jmake_model("RAFT", iters=2)
    x = jnp.zeros((1, H, W, 3))
    params = jax.tree.map(np.array, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), x, x)["params"])
    params["update_block"]["flow_head"]["conv2"]["kernel"] *= 0.01
    tmodel, _ = make_model("RAFT", iters=2)
    tmodel.load_state_dict(raft_params_from_jax(params))
    tmodel.eval().requires_grad_(False)
    return jmodel, params, tmodel


def test_pcfa_attack_matches_jax(raft_models):
    """2 random pairs, RAFT iters 2, steps 2, max_iter 2, history 5: the
    port's batched attack against the JAX attack vmapped over the pairs,
    as the JAX bench runs it. Both in float32. The input gradients carry
    the float32 ReLU-kink noise described in tests/test_torch_raft.py, so
    the metrics agree to 1e-3 relative, or 1e-4 absolute for the AEEs
    between the flows (1e-3 of the flows' scale, ~0.1 here)."""
    jmodel, params, tmodel = raft_models
    rng = np.random.default_rng(5)
    i1 = rng.random((2, H, W, 3)).astype(np.float32)
    i2 = rng.random((2, H, W, 3)).astype(np.float32)
    cfg_kw = dict(steps=2, max_iter=2, delta_bound=0.005, history_size=5,
                  lbfgs_direction="compact")

    def jflow(a, b):
        return jmodel.apply({"params": params}, a, b)[-1]

    jcfg = jpcfa.PCFAConfig(**cfg_kw)
    target = jnp.zeros((2, 1, H, W, 2))
    jres = jax.jit(jax.vmap(
        lambda a, b, t: jpcfa.pcfa_attack(jflow, a, b, t, jcfg)))(
            jnp.asarray(i1[:, None]), jnp.asarray(i2[:, None]), target)

    res = pcfa.pcfa_attack(lambda a, b: tmodel(a, b)[-1], _t(i1), _t(i2),
                           torch.zeros(2, H, W, 2), pcfa.PCFAConfig(**cfg_kw),
                           device="cpu")
    for name in pcfa.PCFAMetrics._fields:
        got = getattr(res.metrics, name).numpy()
        assert got.shape == (2, 2), name
        np.testing.assert_allclose(got, np.asarray(getattr(jres.metrics,
                                                           name)),
                                   rtol=1e-3, atol=1e-4, err_msg=name)
    for name in ("delta1_best", "delta2_best", "delta1", "delta2"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name))[:, 0],
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(res.flow_pred_init.numpy(),
                               np.asarray(jres.flow_pred_init)[:, 0],
                               atol=1e-4)
    # the attack moved the images and kept the best δ under the bound
    assert float(np.abs(res.delta1.numpy()).max()) > 0
    assert (res.metrics.l2_delta12_min[:, -1] <= 0.005).all()


def test_pcfa_entry_points_need_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    x = torch.zeros(1, 8, 8, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pcfa.pcfa_attack(lambda a, b: a[..., :2], x, x, torch.zeros(
            1, 8, 8, 2), pcfa.PCFAConfig(steps=1, max_iter=1))


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imported in a fresh
    interpreter: no jax, flax or pcfa_tpu module gets loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pcfa_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "pcfa_tpu_torch.__path__, 'pcfa_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pcfa_tpu'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 15 else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
