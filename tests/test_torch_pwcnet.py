"""`pcfa_tpu_torch` PWCNet vs `pcfa_tpu` PWCNet on the CPU, through the
weight bridge `pwcnet_params_from_jax`, plus the PCFA attack on it.

Weights: the JAX param tree's shapes (from `eval_shape`, so no compile of
`init`), filled from a numpy seed with LeCun-scaled kernels and non-zero
biases (so the bias mapping is tested too). 128×128 inputs, 2 pairs: the
coarsest level is 2×2.

Flows are compared in float32 at rtol/atol 1e-3. Input gradients are
compared in float64 at 1e-9: LeakyReLU kinks, the sampler's `floor` and
the mask threshold make float32 gradients of a random net differ
elementwise between implementations. In float64 the JAX side runs its
4-corner reference sampler (`PCFA_WARP_VJP=reference`), which is float64
throughout; its default packed VJP computes in float32 even under x64
(`pcfa_tpu/ops/warp.py:406`). The packed VJP itself is held against the
port's in float32 by `tests/test_torch_ops.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcfa_tpu.attack import pcfa as jpcfa
from pcfa_tpu.models import make_model as jmake_model
from pcfa_tpu.models.convert import pwcnet_params_from_state
from pcfa_tpu_torch import runtime
from pcfa_tpu_torch.attack import pcfa
from pcfa_tpu_torch.models import make_model, pwcnet
from pcfa_tpu_torch.models.convert import pwcnet_params_from_jax


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


def _random_tree(shapes, seed=0):
    rng = np.random.default_rng(seed)

    def fill(s):
        if len(s.shape) == 4:  # HWIO: fan-in = kh·kw·I
            fan_in = s.shape[0] * s.shape[1] * s.shape[2]
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree.map(fill, shapes)


@pytest.fixture(scope="module")
def pwc():
    jmodel, _ = jmake_model("PWCNet")
    x = jnp.zeros((1, H, W, 3))
    params = _random_tree(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                         x, x)["params"])
    tmodel, spec = make_model("PWCNet")
    tmodel.load_state_dict(pwcnet_params_from_jax(params), strict=True)
    tmodel.eval().requires_grad_(False)
    return jmodel, params, tmodel


def test_pwcnet_matches_jax(pwc, monkeypatch):
    """The flow in float32; the input gradients of Σ flow·g in float64
    (see the module docstring)."""
    jmodel, params, tmodel = pwc
    rng = np.random.default_rng(0)
    i1 = rng.random((2, H, W, 3)).astype(np.float32)
    i2 = rng.random((2, H, W, 3)).astype(np.float32)
    g = rng.standard_normal((2, H, W, 2)).astype(np.float32)

    def run_jax(dt):
        p = jax.tree.map(lambda a: jnp.asarray(a, dt), params)

        def loss(a, b):
            up = jmodel.apply({"params": p}, a, b)
            return jnp.sum(up * jnp.asarray(g, dt)), up

        (_, up), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(jnp.asarray(i1, dt),
                                                 jnp.asarray(i2, dt))
        return [np.asarray(v, np.float64) for v in (up, *grads)]

    def run_port(dt):
        model = tmodel.to(dt)
        a = torch.from_numpy(i1).to(dt).requires_grad_(True)
        b = torch.from_numpy(i2).to(dt).requires_grad_(True)
        up = model(a, b)
        (up * torch.from_numpy(g).to(dt)).sum().backward()
        return up.detach(), a.grad, b.grad

    up = run_port(torch.float32)[0]
    assert up.dtype == torch.float32 and up.shape == (2, H, W, 2)
    jup = np.asarray(jax.jit(lambda a, b: jmodel.apply(
        {"params": params}, a, b))(jnp.asarray(i1), jnp.asarray(i2)))
    np.testing.assert_allclose(up.numpy(), jup, rtol=1e-3, atol=1e-3)
    assert np.abs(jup).max() > 1.0  # the flow is not trivial

    monkeypatch.setenv("PCFA_WARP_VJP", "reference")
    with jax.enable_x64(True):
        jout = run_jax(jnp.float64)
    out = run_port(torch.float64)
    tmodel.to(torch.float32)
    for got, ref in zip(out, jout):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9, atol=1e-9)
    assert np.abs(jout[1]).max() > 1e-2  # the gradient is not trivial


def test_state_dict_bridges_back_to_jax_tree(pwc):
    """`pcfa_tpu.models.convert.pwcnet_params_from_state` on the port's
    state_dict (the reference key layout, IOHW transposed convs) rebuilds
    the JAX tree exactly."""
    _, params, tmodel = pwc
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    assert "conv1a.0.weight" in sd and "dc_conv7.weight" in sd
    assert sd["upfeat6.weight"].shape == (529, 2, 4, 4)  # IOHW
    assert "deconv2.weight" not in sd
    back = pwcnet_params_from_state(sd)
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, params)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(x), y)


def test_conv_leaky_routes_small_convs(pwc, monkeypatch):
    """The `_PConv3` rule: the pyramid's nine convs of levels 1–3, conv4a
    and dc_conv6 (11 per image) go through `small_conv2d` with a leaky
    epilogue; every other conv is `nn.Conv2d`."""
    _, _, tmodel = pwc
    seen = []
    orig = pwcnet.small_conv2d

    def spy(x, w, b, stride, act):
        seen.append((x.shape[1], w.shape[0], stride, act))
        return orig(x, w, b, stride, act)

    monkeypatch.setattr(pwcnet, "small_conv2d", spy)
    x = torch.rand(1, H, W, 3)
    with torch.no_grad():
        tmodel(x, x)
    assert seen == [(3, 16, 2, "leaky"), (16, 16, 1, "leaky"),
                    (16, 16, 1, "leaky"), (16, 32, 2, "leaky"),
                    (32, 32, 1, "leaky"), (32, 32, 1, "leaky"),
                    (32, 64, 2, "leaky"), (64, 64, 1, "leaky"),
                    (64, 64, 1, "leaky"), (64, 96, 2, "leaky"),
                    (64, 32, 1, "leaky")]


def test_pcfa_step_on_pwcnet_matches_jax(pwc):
    """One outer step of one L-BFGS iteration (float32 history, as PWCNet
    requires) on 2 pairs at 64×64: the port's batched attack against the
    JAX attack vmapped over the pairs, both float32, at 1e-3 relative and
    1e-4 absolute. A second iteration is not compared here: its curvature
    pair y = g₁ − g₀ is ~1% of g on this random net, so a float32 flip of a
    LeakyReLU unit or of the warp mask's threshold (4e-4 of g, seen on
    either side at some iterates) moves that step by several percent. The
    multi-iteration trajectory is held for RAFT in
    tests/test_torch_attack.py."""
    jmodel, params, tmodel = pwc
    h = w = 64
    rng = np.random.default_rng(6)
    i1 = rng.random((2, h, w, 3)).astype(np.float32)
    i2 = rng.random((2, h, w, 3)).astype(np.float32)
    cfg_kw = dict(steps=1, max_iter=1, delta_bound=0.005, history_size=5,
                  lbfgs_direction="compact")

    jcfg = jpcfa.PCFAConfig(**cfg_kw)
    jres = jax.jit(jax.vmap(lambda a, b, t: jpcfa.pcfa_attack(
        lambda x, y: jmodel.apply({"params": params}, x, y), a, b, t,
        jcfg)))(jnp.asarray(i1[:, None]), jnp.asarray(i2[:, None]),
                jnp.zeros((2, 1, h, w, 2)))
    res = pcfa.pcfa_attack(tmodel, torch.from_numpy(i1), torch.from_numpy(i2),
                           torch.zeros(2, h, w, 2), pcfa.PCFAConfig(**cfg_kw),
                           device="cpu")
    for name in pcfa.PCFAMetrics._fields:
        got = getattr(res.metrics, name).numpy()
        assert got.shape == (2, 1), name
        np.testing.assert_allclose(got, np.asarray(getattr(jres.metrics,
                                                           name)),
                                   rtol=1e-3, atol=1e-4, err_msg=name)
    for name in ("delta1", "delta2", "flow_pred"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name))[:, 0],
                                   atol=1e-4, err_msg=name)
    assert float(np.abs(res.delta1.numpy()).max()) > 0


def test_init_random_transposed_fan_in():
    """A transposed conv's fan-in is its input channels × taps, as flax's
    `lecun_normal` takes it for a `ConvTranspose` kernel (kh, kw, I, O):
    the port's weight std matches flax's within sampling noise."""
    import flax.linen as fnn

    c_in = 529  # PWCNet's upfeat6
    k = fnn.ConvTranspose(2, (4, 4), strides=(2, 2), padding="SAME").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 2, c_in)))["params"]["kernel"]
    m = torch.nn.ConvTranspose2d(c_in, 2, 4, 2, 1)
    runtime.init_random_(m, seed=0)
    want = 1.0 / np.sqrt(c_in * 16)
    for std in (float(np.std(np.asarray(k))),
                float(m.weight.detach().std())):
        assert abs(std / want - 1.0) < 0.05, (std, want)
    assert not m.bias.any()


def test_runtime_pwcnet_flow_fn_on_cpu(monkeypatch):
    """load_model + make_flow_fn for PWCNet: the ÷64 pad, the flow returned
    directly (not a tuple), unpadded float32 flow; bf16 compute too."""
    loaded = runtime.load_model("PWCNet", init_random=True, seed=1,
                                device="cpu")
    assert loaded.spec.pad_divisor == 64
    padder, flow_fn = runtime.make_flow_fn(loaded, (100, 130), "kitti")
    assert padder.padded_shape == (128, 192)
    rng = np.random.default_rng(2)
    x1, x2 = padder.pad(*(torch.from_numpy(rng.random((1, 100, 130, 3))
                                           .astype(np.float32))
                          for _ in range(2)))
    flow = flow_fn(x1, x2)
    assert flow.shape == (1, 100, 130, 2) and flow.dtype == torch.float32
    assert torch.isfinite(flow).all()
    monkeypatch.setenv("PCFA_COMPUTE_DTYPE", "bfloat16")
    _, flow_fn16 = runtime.make_flow_fn(loaded, (100, 130), "kitti")
    flow16 = flow_fn16(x1, x2)
    assert flow16.dtype == torch.float32 and torch.isfinite(flow16).all()
