"""`pcfa_tpu_torch` RAFT-small vs `pcfa_tpu` RAFTSmall on the CPU, through
the weight bridge `raft_small_params_from_jax`.

Weights: the JAX tree's shapes (from `eval_shape`, no compile of `init`),
filled from a numpy seed with LeCun-scaled kernels and small nonzero
biases, the flow head's conv2 damped ×0.01 (as tests/test_torch_raft.py).
One pair at 128×128 (the coarsest pyramid level is then 2×2), 2
iterations.

Flows are compared in float32 at rtol/atol 1e-3 and the input gradients in
float64 at 1e-9, as tests/test_torch_raft.py does for RAFT and says why. In
float64 the comparison stops at flow_lr (the flow and the gradients of
Σ flow_lr·g): the JAX package's bilinear resize matrices are float32 under
x64 too (`pcfa_tpu/ops/warp.py:_resize_matrix`), so its ×8 align_corners
`upflow` weights (k·15/127 at 16 → 128) are rounded to float32, ~1e-7 of
a value. `upflow` itself is held to the JAX one in float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcfa_tpu.models import make_model as jmake_model
from pcfa_tpu.models.convert import raft_small_params_from_state
from pcfa_tpu.models.layers import SmallEncoder as JSmallEncoder
from pcfa_tpu.ops.warp import upflow as jupflow
from pcfa_tpu_torch import runtime
from pcfa_tpu_torch.attack.pcfa import PCFAConfig, pcfa_attack
from pcfa_tpu_torch.models import convert, get_spec, make_model
from pcfa_tpu_torch.models.convert import raft_small_params_from_jax
from pcfa_tpu_torch.models.layers import SmallEncoder
from pcfa_tpu_torch.ops.warp import upflow


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


def _fill(shapes, seed=0):
    rng = np.random.default_rng(seed)

    def fill(s):
        if len(s.shape) == 4:  # HWIO: fan-in = kh·kw·I
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:3]))).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree.map(fill, shapes)


@pytest.fixture(scope="module")
def nets():
    jmodel, _ = jmake_model("RAFT-small", iters=ITERS)
    x = jnp.zeros((1, H, W, 3))
    params = _fill(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x,
                                  x)["params"])
    ub = params["update_block"]
    ub["flow_head_conv2"] = {k: 0.01 * v for k, v in
                             ub["flow_head_conv2"].items()}
    tmodel, _ = make_model("RAFT-small", iters=ITERS)
    tmodel.load_state_dict(raft_small_params_from_jax(params), strict=True)
    tmodel.eval().requires_grad_(False)
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    i1, i2 = (rng.random((1, H, W, 3)) for _ in range(2))
    return i1, i2, rng.standard_normal((1, H // 8, W // 8, 2))


def _flow_and_grads(model, inputs):
    """The port's float64 flow_lr and input gradients of Σ flow_lr·g."""
    i1, i2, g = inputs
    a, b = (torch.from_numpy(x).requires_grad_(True) for x in (i1, i2))
    lr, _ = model.double()(a, b)
    (lr * torch.from_numpy(g)).sum().backward()
    model.float()
    return [t.detach().numpy() for t in (lr, a.grad, b.grad)]


@pytest.fixture(scope="module")
def port_f64(nets, inputs):
    return _flow_and_grads(nets[2], inputs)


def test_raft_small_matches_jax(nets, inputs, port_f64):
    """flow_lr and flow_up in float32; in float64 flow_lr and the input
    gradients of Σ flow_lr·g."""
    jmodel, params, tmodel = nets
    i1, i2, g = inputs
    jlr, jup = jax.jit(lambda a, b: jmodel.apply(
        {"params": jax.tree.map(jnp.asarray, params)}, a, b))(
            i1.astype(np.float32), i2.astype(np.float32))
    with torch.no_grad():
        lr, up = tmodel(*(torch.from_numpy(a).float() for a in (i1, i2)))
    assert lr.shape == (1, H // 8, W // 8, 2) and up.shape == (1, H, W, 2)
    assert lr.dtype == up.dtype == torch.float32
    np.testing.assert_allclose(lr.numpy(), np.asarray(jlr), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(up.numpy(), np.asarray(jup), rtol=1e-3,
                               atol=1e-3)
    assert np.abs(np.asarray(jup)).max() > 1e-2  # the flow is not trivial

    def loss(p, a, b):
        lr, _ = jmodel.apply({"params": p}, a, b)
        return jnp.sum(lr * g), lr

    with jax.enable_x64(True):
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        (_, jlr), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(1, 2), has_aux=True))(p, jnp.asarray(i1),
                                                 jnp.asarray(i2))
        jout = [np.asarray(v) for v in (jlr, *grads)]
    for got, ref in zip(port_f64, jout):
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)
    assert np.abs(jout[1]).max() > 1e-2  # the gradient is not trivial


@pytest.mark.parametrize("policy", [None, "dots"])
def test_raft_small_remat_changes_nothing(nets, inputs, port_f64, policy):
    """remat (recompute the whole iteration, or keep its products) gives
    the float64 flow and input gradients of the run without remat."""
    model, _ = make_model("RAFT-small", iters=ITERS, remat=True,
                          remat_policy=policy)
    model.load_state_dict(nets[2].state_dict())
    model.eval().requires_grad_(False)
    for got, want in zip(_flow_and_grads(model, inputs), port_f64):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_small_encoder_and_upflow_match_jax():
    """`SmallEncoder` with each norm at an odd size (stride-2 shortcuts on
    odd maps), and `upflow` (×8, align_corners=True), against the JAX
    modules in float32."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 56, 3)).astype(np.float32)
    for norm_fn in ("instance", "none"):
        jenc = JSmallEncoder(output_dim=40, norm_fn=norm_fn)
        params = _fill(jax.eval_shape(jenc.init, jax.random.PRNGKey(0),
                                      jnp.zeros_like(x))["params"], 4)
        ref = np.asarray(jenc.apply({"params": params}, x))
        enc = SmallEncoder(40, norm_fn)
        sd = {}
        convert._small_encoder(sd, "e", params)
        enc.load_state_dict({k[2:]: torch.from_numpy(v)
                             for k, v in sd.items()}, strict=True)
        with torch.no_grad():
            got = enc(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert got.shape == (2, 40, 5, 7)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                                   rtol=1e-4, atol=1e-4)
    flow = rng.standard_normal((2, 5, 7, 2)).astype(np.float32)
    got = upflow(torch.from_numpy(flow))
    assert got.shape == (2, 40, 56, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(jupflow(flow)),
                               rtol=1e-5, atol=1e-5)


def test_state_dict_bridges_back_to_jax_tree(nets):
    """The port's state_dict has the reference torch RAFT-small's keys:
    `pcfa_tpu.models.convert.raft_small_params_from_state` reads it into
    the JAX tree exactly, and nothing is left over."""
    _, params, tmodel = nets
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    assert "fnet.layer2.0.downsample.0.weight" in sd
    assert "fnet.layer1.0.downsample.0.weight" not in sd
    assert sd["update_block.encoder.convc1.weight"].shape == (96, 196, 1, 1)
    assert sd["update_block.gru.convz.weight"].shape == (96, 242, 3, 3)
    back = raft_small_params_from_state(sd)
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, params)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(x), y)
    n = sum(np.asarray(x).size for x in jax.tree.leaves(back))
    assert n == sum(v.size for v in sd.values()) == 990162


def test_raft_small_registry_runtime_and_attack():
    """RAFT-small: pad divisor 8, 12 iterations; no default checkpoint
    (FileNotFoundError without weights); random weights with flax's
    default initializers (LeCun-normal kernels by fan-in, zero biases);
    load_model → make_flow_fn → pcfa_attack on the CPU."""
    spec = get_spec("RAFT-small")
    assert (spec.pad_divisor, spec.iters, spec.defaults) == (8, 12,
                                                             {"iters": 12})
    assert make_model("RAFT-small")[0].iters == 12
    assert "RAFT-small" not in runtime.WEIGHT_PATHS
    with pytest.raises(FileNotFoundError, match="no default checkpoint"):
        runtime.load_model("RAFT-small", device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            runtime.load_model("RAFT-small", init_random=True)
    loaded = runtime.load_model("RAFT-small", init_random=True, seed=0,
                                device="cpu", iters=2)
    sd = loaded.module.state_dict()
    assert not any(v.any() for k, v in sd.items() if k.endswith(".bias"))
    w = sd["update_block.encoder.convc1.weight"]
    assert abs(float(w.std()) * np.sqrt(196) - 1.0) < 0.05

    padder, flow_fn = runtime.make_flow_fn(loaded, (122, 130))
    assert padder.padded_shape == (128, 136)
    rng = np.random.default_rng(4)
    x1, x2 = padder.pad(*(torch.from_numpy(rng.random((1, 122, 130, 3))
                                           .astype(np.float32))
                          for _ in range(2)))
    res = pcfa_attack(flow_fn, x1, x2, torch.zeros(1, 122, 130, 2),
                      PCFAConfig(steps=1, max_iter=2), device="cpu")
    assert torch.isfinite(res.metrics.aee_adv_tgt).all()
    assert float(res.delta1.abs().max()) > 0
