"""`pcfa_tpu_torch` RAFT vs `pcfa_tpu` RAFT on the CPU, through the weight
bridge `raft_params_from_jax`.

The pattern of tests/test_raft.py: random init, flow-head `conv2` damped
×0.01 so the random recurrent net stays tame, 128×128 inputs, 3
iterations, rtol/atol 1e-3.

Flows are compared in float32. The input gradients are compared with both
models in float64: a random-init RAFT has pre-activations within ~1e-6 of
a ReLU kink, so float32 rounding switches a few units on or off, and at
these shapes either package's float32 input gradient differs from its own
float64 gradient by up to 5e-3 on ~0.3% of the pixels (each package on
other pixels), more than the tolerance. In float64 nothing is rounded to
float32 on either side, and the two packages agree to ~1e-15 in flows and
gradients (gradient scale ~0.2), so float64 is held to rtol/atol 1e-9.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcfa_tpu.models import make_model as jmake_model
from pcfa_tpu.models.convert import raft_params_from_state
from pcfa_tpu.models.raft import upsample_flow_convex as jupsample
from pcfa_tpu_torch import runtime
from pcfa_tpu_torch.models import get_spec, make_model
from pcfa_tpu_torch.models.convert import raft_params_from_jax
from pcfa_tpu_torch.models.layers import BasicEncoder
from pcfa_tpu_torch.models.raft import upsample_flow_convex


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
ITERS = 3


def _jax_raft_params(iters=ITERS, hw=(H, W)):
    model, _ = jmake_model("RAFT", iters=iters)
    x = jnp.zeros((1, *hw, 3))
    params = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.PRNGKey(0), x, x)["params"])
    head = params["update_block"]["flow_head"]["conv2"]
    head["kernel"] = head["kernel"] * 0.01
    head["bias"] = head["bias"] * 0.01
    return model, params


@pytest.fixture(scope="module")
def raft_pair():
    jmodel, params = _jax_raft_params()
    tmodel, _ = make_model("RAFT", iters=ITERS)
    tmodel.load_state_dict(raft_params_from_jax(params), strict=True)
    tmodel.eval().requires_grad_(False)
    return jmodel, params, tmodel


def test_raft_matches_jax(raft_pair):
    """flow_lr and flow_up in float32; the input gradients of Σ flow_up·g
    in float64 (see the module docstring)."""
    jmodel, params, tmodel = raft_pair
    rng = np.random.default_rng(0)
    i1 = rng.random((2, H, W, 3)).astype(np.float32)
    i2 = rng.random((2, H, W, 3)).astype(np.float32)
    g = rng.standard_normal((2, H, W, 2)).astype(np.float32)

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

    tol = dict(rtol=1e-3, atol=1e-3)
    jlr, jup, _, _ = run_jax(jnp.float32)
    lr, up, _, _ = run_port(torch.float32)
    assert lr.dtype == up.dtype == torch.float32
    assert lr.shape == (2, H // 8, W // 8, 2) and up.shape == (2, H, W, 2)
    np.testing.assert_allclose(lr.numpy(), jlr, **tol)
    np.testing.assert_allclose(up.numpy(), jup, **tol)

    with jax.enable_x64(True):
        jout = run_jax(jnp.float64)
    out = run_port(torch.float64)
    tmodel.to(torch.float32)
    for got, ref in zip(out, jout):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9, atol=1e-9)
    assert np.abs(jout[2]).max() > 1e-2  # the gradient is not trivial


def _reference_state(sd):
    """The port's state_dict in the reference torch RAFT's layout: each
    folded BatchNorm (scale, bias) as weight = scale, running_mean = 0 and
    running_var = 1 − eps, which `fold_batchnorm` folds back exactly."""
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


def test_state_dict_bridges_back_to_jax_tree(raft_pair):
    """`pcfa_tpu.models.convert.raft_params_from_state` on the port's
    state_dict (reference key layout) rebuilds the JAX tree: same shapes
    and the same values."""
    _, params, tmodel = raft_pair
    back = raft_params_from_state(_reference_state(tmodel.state_dict()))
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, params)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_allclose(np.asarray(x), y, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("norm_fn", ["instance", "batch"])
def test_basic_encoder_matches_jax(norm_fn):
    from pcfa_tpu.models.layers import BasicEncoder as JEncoder
    from pcfa_tpu_torch.models.convert import _encoder

    rng = np.random.default_rng(1)
    x = rng.random((2, 40, 56, 3)).astype(np.float32)
    jenc = JEncoder(64, norm_fn)
    p = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(1),
                                           jnp.asarray(x))["params"])
    if norm_fn == "batch":  # non-trivial folded BatchNorms
        p = jax.tree_util.tree_map_with_path(
            lambda path, v: v * 1.5 + 0.1 if "norm" in str(path) else v, p)
    sd = {}
    _encoder(sd, "e", p)
    tenc = BasicEncoder(64, norm_fn)
    tenc.load_state_dict({k[2:]: torch.from_numpy(np.array(v))
                          for k, v in sd.items()})
    got = tenc(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    ref = np.asarray(jenc.apply({"params": p}, jnp.asarray(x)))
    assert got.shape == ref.shape == (2, 5, 7, 64)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-4)


def test_upsample_flow_convex_matches_jax():
    rng = np.random.default_rng(2)
    flow = rng.standard_normal((2, 5, 7, 2)).astype(np.float32)
    mask = rng.standard_normal((2, 5, 7, 576)).astype(np.float32)
    ref = np.asarray(jupsample(jnp.asarray(flow), jnp.asarray(mask)))
    got = upsample_flow_convex(torch.from_numpy(flow), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (2, 40, 56, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    # a bf16 mask never drags the fp32 flow down to bf16
    got16 = upsample_flow_convex(torch.from_numpy(flow),
                                 torch.from_numpy(mask).to(torch.bfloat16))
    assert got16.dtype == torch.float32


def test_model_registry():
    spec = get_spec("RAFT")
    assert (spec.pad_divisor, spec.iters) == (8, 12)
    module, spec2 = make_model("RAFT")
    assert module.iters == 12 and spec2 is spec
    pwc = get_spec("PWCNet")
    assert (pwc.pad_divisor, pwc.iters) == (64, None)
    with pytest.raises(KeyError, match="PWCNet"):
        get_spec("FlowNetX")


def test_runtime_flow_fn_on_cpu(monkeypatch):
    """load_model + make_flow_fn: deterministic random weights from the
    seed, padded input, unpadded float32 flow; bf16 compute keeps the
    returned flow float32."""
    kw = dict(init_random=True, seed=3, device="cpu", iters=2)
    a, b = runtime.load_model("RAFT", **kw), runtime.load_model("RAFT", **kw)
    for x, y in zip(a.module.state_dict().values(),
                    b.module.state_dict().values()):
        assert torch.equal(x, y)
    assert not any(p.requires_grad for p in a.module.parameters())

    # the coarsest pyramid level must be ≥ 2×2 (the plain lookup's grid
    # normalization divides by W − 1, as in both packages)
    padder, flow_fn = runtime.make_flow_fn(a, (122, 130))
    assert padder.padded_shape == (128, 136)
    rng = np.random.default_rng(4)
    x1, x2 = (torch.from_numpy(rng.random((1, 122, 130, 3)).astype(np.float32))
              for _ in range(2))
    x1, x2 = padder.pad(x1, x2)
    flow = flow_fn(x1, x2)
    assert flow.shape == (1, 122, 130, 2) and flow.dtype == torch.float32
    assert torch.isfinite(flow).all()

    monkeypatch.setenv("PCFA_COMPUTE_DTYPE", "bfloat16")
    _, flow_fn16 = runtime.make_flow_fn(a, (122, 130))
    flow16 = flow_fn16(x1, x2)
    assert flow16.dtype == torch.float32
    assert torch.isfinite(flow16).all()
    assert next(a.module.parameters()).dtype == torch.float32


def test_runtime_refuses_missing_weights_and_gpu(tmp_path, monkeypatch):
    """No checkpoint at the default path (relative to the working
    directory) and no init_random: FileNotFoundError. The default device
    needs a GPU."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="init_random=True"):
        runtime.load_model("RAFT", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            runtime.load_model("RAFT", init_random=True)
