"""`pcfa_tpu_torch` GMA vs `pcfa_tpu` GMA on the CPU, through the weight
bridge `gma_params_from_jax`.

Weights: the JAX tree's shapes (from `eval_shape`, no compile of `init`),
filled from a numpy seed with LeCun-scaled kernels, small nonzero biases
and folded BatchNorms, standard-normal relative-position tables, the flow
head's conv2 damped ×0.01 (as tests/test_torch_raft.py), and the residual
gain `gamma` at 0.5: at its initial 0 the aggregation adds nothing, and a
broken attention would pass. One pair at 128×128, 2 iterations.

Flows are compared in float32 at rtol/atol 1e-3 and the input gradients in
float64 at 1e-9, as tests/test_torch_raft.py does for RAFT and says why.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcfa_tpu.models import make_model as jmake_model
from pcfa_tpu.models.convert import gma_params_from_state
from pcfa_tpu_torch import runtime
from pcfa_tpu_torch.models import get_spec, make_model
from pcfa_tpu_torch.models.convert import gma_params_from_jax


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


H = W = 128
ITERS = 2
VARIANTS = {"content": {}, "position_only": {"position_only": True},
            "position_and_content": {"position_and_content": True}}


@pytest.fixture(scope="module")
def tree():
    """One random tree of the positional variants' shapes; content-only
    attention takes it without `att.pos_emb`."""
    jmodel, _ = jmake_model("GMA", iters=ITERS, position_only=True)
    x = jnp.zeros((1, H, W, 3))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x,
                            x)["params"]
    rng = np.random.default_rng(0)

    def fill(path, s):
        if "pos_emb" in jax.tree_util.keystr(path):
            return rng.standard_normal(s.shape).astype(np.float32)
        if len(s.shape) == 4:  # HWIO: fan-in = kh·kw·I
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:3]))).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    ub = params["update_block"]
    ub["aggregator"]["gamma"] = np.full((1,), 0.5, np.float32)
    head = ub["flow_head"]["conv2"]
    head["kernel"], head["bias"] = 0.01 * head["kernel"], 0.01 * head["bias"]
    return params


def _variant(tree, name):
    params = jax.tree.map(lambda a: a, tree)
    if name == "content":
        del params["att"]["pos_emb"]
    jmodel, _ = jmake_model("GMA", iters=ITERS, **VARIANTS[name])
    tmodel, _ = make_model("GMA", iters=ITERS, **VARIANTS[name])
    tmodel.load_state_dict(gma_params_from_jax(params), strict=True)
    tmodel.eval().requires_grad_(False)
    return jmodel, params, tmodel


@pytest.mark.parametrize("name", list(VARIANTS))
def test_gma_matches_jax(tree, name):
    """flow_lr and flow_up in float32; in float64 the flows and the input
    gradients of Σ flow_up·g."""
    jmodel, params, tmodel = _variant(tree, name)
    rng = np.random.default_rng(1)
    i1, i2 = (rng.random((1, H, W, 3)) for _ in range(2))
    g = rng.standard_normal((1, H, W, 2))

    def run_jax(dt):
        p = jax.tree.map(lambda a: jnp.asarray(a, dt), params)

        def loss(a, b):
            lr, up = jmodel.apply({"params": p}, a, b)
            return jnp.sum(up * jnp.asarray(g, dt)), (lr, up)

        (_, (lr, up)), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(jnp.asarray(i1, dt),
                                                 jnp.asarray(i2, dt))
        return [np.asarray(v, np.float64) for v in (lr, up, *grads)]

    def run_port(dt):
        model = tmodel.to(dt)
        a = torch.from_numpy(i1).to(dt).requires_grad_(True)
        b = torch.from_numpy(i2).to(dt).requires_grad_(True)
        lr, up = model(a, b)
        (up * torch.from_numpy(g).to(dt)).sum().backward()
        return lr.detach(), up.detach(), a.grad, b.grad

    jlr, jup = jax.jit(lambda a, b: jmodel.apply(
        {"params": jax.tree.map(jnp.asarray, params)}, a, b))(
            i1.astype(np.float32), i2.astype(np.float32))
    with torch.no_grad():
        lr, up = tmodel(*(torch.from_numpy(a).float() for a in (i1, i2)))
    assert lr.shape == (1, H // 8, W // 8, 2) and up.shape == (1, H, W, 2)
    np.testing.assert_allclose(lr.numpy(), np.asarray(jlr), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(up.numpy(), np.asarray(jup), rtol=1e-3,
                               atol=1e-3)

    with jax.enable_x64(True):
        jout = run_jax(jnp.float64)
    out = run_port(torch.float64)
    tmodel.to(torch.float32)
    for got, ref in zip(out, jout):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9, atol=1e-9)
    assert np.abs(jout[2]).max() > 1e-2  # the gradient is not trivial


@pytest.fixture(scope="module")
def gma_f64(tree):
    """The port's GMA (content-only, materialized, no remat) and its
    float64 flow and input gradients of Σ flow_up·g."""
    _, _, tmodel = _variant(tree, "content")
    return tmodel, _flow_and_grads(tmodel)


def _flow_and_grads(model):
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.random((1, H, W, 3))).requires_grad_(True)
            for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((1, H, W, 2)))
    _, up = model.double()(a, b)
    (up * g).sum().backward()
    model.float()
    return [t.detach().numpy() for t in (up, a.grad, b.grad)]


@pytest.mark.parametrize("kw,tol", [
    (dict(remat=True), 1e-9), (dict(remat=True, remat_policy="dots"), 1e-9),
    (dict(corr_impl="fused", corr_block=100), 1e-6),
    (dict(corr_impl="hybrid", corr_block=100, remat=True), 1e-6)])
def test_gma_remat_and_corr_paths(gma_f64, kw, tol):
    """GMA runs RAFT's loop: remat (None, 'dots') leaves the float64 flow
    and input gradients unchanged (1e-9); the fused and hybrid corr paths
    (blocks of 100 of 256 queries) differ from the materialized one by
    their float32 rows (1e-6, as tests/test_torch_corr.py holds RAFT)."""
    tmodel, ref = gma_f64
    model, _ = make_model("GMA", iters=ITERS, **kw)
    model.load_state_dict(tmodel.state_dict())
    model.eval().requires_grad_(False)
    for got, want in zip(_flow_and_grads(model), ref):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert np.abs(ref[1]).max() > 1e-2


def _reference_state(sd):
    """The port's state_dict in the reference torch GMA's layout: each
    folded BatchNorm as weight = scale, running_mean = 0 and running_var =
    1 − eps, which the fold maps back exactly."""
    out = {}
    for k, v in sd.items():
        v = v.numpy()
        if k.endswith(".scale"):
            stem = k[:-len(".scale")]
            out[f"{stem}.weight"] = v
            out[f"{stem}.running_mean"] = np.zeros_like(v)
            out[f"{stem}.running_var"] = np.full_like(v, 1.0 - 1e-5)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("name", ["content", "position_and_content"])
def test_gma_state_dict_bridges_back_to_jax_tree(tree, name):
    """`pcfa_tpu.models.convert.gma_params_from_state` on the port's
    state_dict (the reference key layout) rebuilds the JAX tree: same
    shapes, same values."""
    _, params, tmodel = _variant(tree, name)
    sd = tmodel.state_dict()
    assert "att.to_qk.weight" in sd and "update_block.aggregator.gamma" in sd
    assert ("att.pos_emb.rel_height.weight" in sd) == (name != "content")
    back = gma_params_from_state(_reference_state(sd),
                                 include_pos_emb=name != "content")
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, params)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_allclose(np.asarray(x), y, rtol=1e-6, atol=1e-7)


def test_gma_registry_and_runtime():
    """GMA: pad divisor 8, 6 iterations; the shipped config (content-only
    attention, one head) by default; runs through load_model and
    make_flow_fn with random weights (gamma starts at 0, as in
    `pcfa_tpu`)."""
    spec = get_spec("GMA")
    assert (spec.pad_divisor, spec.iters, spec.defaults) == (8, 6,
                                                             {"iters": 6})
    loaded = runtime.load_model("GMA", init_random=True, seed=0,
                                device="cpu", iters=1)
    sd = loaded.module.state_dict()
    assert not any(k.startswith("att.pos_emb") for k in sd)
    assert sd["update_block.gru.convz1.weight"].shape == (128, 512, 1, 5)
    assert float(sd["update_block.aggregator.gamma"]) == 0.0
    assert make_model("GMA")[0].iters == 6
    # ≥ 128 px a side: the coarsest pyramid level must be ≥ 2×2
    padder, flow_fn = runtime.make_flow_fn(loaded, (122, 130))
    assert padder.padded_shape == (128, 136)
    x1, x2 = padder.pad(*(torch.rand(1, 122, 130, 3) for _ in range(2)))
    flow = flow_fn(x1, x2)
    assert flow.shape == (1, 122, 130, 2) and torch.isfinite(flow).all()
