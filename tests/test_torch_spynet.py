"""`pcfa_tpu_torch` SpyNet vs `pcfa_tpu` SpyNet on the CPU, through the
weight bridge `spynet_params_from_jax`, and SpyNet's per-layer weight
directory.

Weights: the JAX tree's shapes (from `eval_shape`, no compile of `init`),
filled from a numpy seed with LeCun-scaled kernels and small nonzero
biases. Cases: 4 levels at 32×48 (one pair) and the full 6 levels at
64×128 (two pairs).

Flows are compared in float32 at rtol/atol 1e-3; in float64 the flow and
the input gradients of Σ flow·g at 1e-9. The JAX package's packed warp VJP
computes in float32 even under x64, so its float64 run takes its 4-corner
reference VJP (`PCFA_WARP_VJP=reference`), as tests/test_torch_pwcnet.py
does. Its bilinear resize matrices are float32 too, but SpyNet's ×2
align_corners=False weights (¼, ¾) are exact in float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcfa_tpu import runtime as jruntime
from pcfa_tpu.models import make_model as jmake_model
from pcfa_tpu.models.convert import spynet_params_from_files
from pcfa_tpu.models.spynet import spynet_warp as jspynet_warp
from pcfa_tpu_torch import runtime
from pcfa_tpu_torch.attack.pcfa import PCFAConfig, pcfa_attack
from pcfa_tpu_torch.models import convert, get_spec, make_model
from pcfa_tpu_torch.models import spynet as spynet_module
from pcfa_tpu_torch.models.convert import spynet_params_from_jax
from pcfa_tpu_torch.models.spynet import spynet_warp


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


# nlevels: (pairs, H, W)
CASES = {4: (1, 32, 48), 6: (2, 64, 128)}


def _nets(nlevels, seed=0):
    pairs, H, W = CASES[nlevels]
    jmodel, _ = jmake_model("SpyNet", nlevels=nlevels)
    x = jnp.zeros((1, H, W, 3))
    rng = np.random.default_rng(seed)

    def fill(s):
        if len(s.shape) == 4:  # HWIO: fan-in = kh·kw·I
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:3]))).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    params = jax.tree.map(fill, jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), x, x)["params"])
    tmodel, _ = make_model("SpyNet", nlevels=nlevels)
    tmodel.load_state_dict(spynet_params_from_jax(params), strict=True)
    tmodel.eval().requires_grad_(False)
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def six_levels():
    return _nets(6)


@pytest.mark.parametrize("nlevels", list(CASES))
def test_spynet_matches_jax(nlevels, six_levels, monkeypatch):
    jmodel, params, tmodel = six_levels if nlevels == 6 else _nets(nlevels)
    pairs, H, W = CASES[nlevels]
    rng = np.random.default_rng(1)
    i1, i2 = (rng.random((pairs, H, W, 3)) for _ in range(2))
    g = rng.standard_normal((pairs, H, W, 2))

    jflow = np.asarray(jax.jit(lambda a, b: jmodel.apply(
        {"params": jax.tree.map(jnp.asarray, params)}, a, b))(
            i1.astype(np.float32), i2.astype(np.float32)))
    with torch.no_grad():
        flow = tmodel(*(torch.from_numpy(a).float() for a in (i1, i2)))
    assert flow.shape == (pairs, H, W, 2) and flow.dtype == torch.float32
    np.testing.assert_allclose(flow.numpy(), jflow, rtol=1e-3, atol=1e-3)
    assert np.abs(jflow).max() > 1e-1  # the flow is not trivial

    def loss(p, a, b):
        out = jmodel.apply({"params": p}, a, b)
        return jnp.sum(out * g), out

    monkeypatch.setenv("PCFA_WARP_VJP", "reference")
    with jax.enable_x64(True):
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        (_, jout), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(1, 2), has_aux=True))(p, jnp.asarray(i1),
                                                 jnp.asarray(i2))
        ref = [np.asarray(v) for v in (jout, *grads)]
    a, b = (torch.from_numpy(x).requires_grad_(True) for x in (i1, i2))
    out = tmodel.double()(a, b)
    (out * torch.from_numpy(g)).sum().backward()
    tmodel.float()
    for got, want in zip((out.detach(), a.grad, b.grad), ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)
    assert np.abs(ref[2]).max() > 1e-2  # frame 2's gradient is not trivial


def test_spynet_bf16_casts_conv_inputs_and_keeps_the_grid_float32(
        six_levels, monkeypatch):
    """Under bf16 compute every conv gets a bf16 input (the warp and the
    upsampling hand it float32), each level's warp gets a float32 grid,
    and the flow comes back float32, near the float32 flow."""
    tmodel = six_levels[2]
    seen = {"conv": [], "grid": []}
    conv, sample = spynet_module.small_conv2d, spynet_module.grid_sample

    def conv_spy(x, *args):
        seen["conv"].append(x.dtype)
        return conv(x, *args)

    def sample_spy(img, grid, **kw):
        seen["grid"].append((img.dtype, grid.dtype))
        return sample(img, grid, **kw)

    monkeypatch.setattr(spynet_module, "small_conv2d", conv_spy)
    monkeypatch.setattr(spynet_module, "grid_sample", sample_spy)
    loaded = runtime.LoadedModel("SpyNet", tmodel, get_spec("SpyNet"),
                                 torch.device("cpu"))
    rng = np.random.default_rng(2)
    x1, x2 = (torch.from_numpy(rng.random((2, 64, 128, 3))
                               .astype(np.float32)) for _ in range(2))
    ref = runtime.make_flow_fn(loaded, (64, 128))[1](x1, x2)
    seen["conv"].clear()
    seen["grid"].clear()
    monkeypatch.setenv("PCFA_COMPUTE_DTYPE", "bfloat16")
    flow = runtime.make_flow_fn(loaded, (64, 128))[1](x1, x2)
    assert seen["conv"] == [torch.bfloat16] * 30
    assert seen["grid"] == [(torch.bfloat16, torch.float32)] * 6
    assert flow.dtype == torch.float32 and torch.isfinite(flow).all()
    assert float((flow - ref).abs().max()) < 0.1 * float(ref.abs().max())


def test_spynet_warp_clip_derivative_matches_jnp_clip(monkeypatch):
    """At a zero flow (level 0's) the grid lies exactly on ±1 at the
    border pixels. There `jnp.clip`'s derivative is ½, and so is the
    port's (max then min); `torch.clamp`'s would be 1. The flow gradient
    of Σ warp·g agrees with the JAX one in float64 there and at a random
    flow that pushes samples past the border."""
    rng = np.random.default_rng(3)
    img = rng.standard_normal((1, 6, 9, 3))
    g = rng.standard_normal((1, 6, 9, 3))
    monkeypatch.setenv("PCFA_WARP_VJP", "reference")
    for flow in (np.zeros((1, 6, 9, 2)),
                 3.0 * rng.standard_normal((1, 6, 9, 2))):
        with jax.enable_x64(True):
            ref = np.asarray(jax.grad(lambda f: jnp.sum(jspynet_warp(
                jnp.asarray(img), f) * g))(jnp.asarray(flow)))
        f = torch.from_numpy(flow).requires_grad_(True)
        (spynet_warp(torch.from_numpy(img), f) * torch.from_numpy(g)).sum(
            ).backward()
        np.testing.assert_allclose(f.grad.numpy(), ref, rtol=1e-9, atol=1e-9)
    # the border pixels see the bound: through `torch.clamp` their x
    # gradient would be twice the JAX one
    f = torch.zeros((1, 6, 9, 2), dtype=torch.float64, requires_grad=True)
    xs = torch.linspace(-1.0, 1.0, 9, dtype=torch.float64)
    ys = torch.linspace(-1.0, 1.0, 6, dtype=torch.float64)
    base = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
    grid = (base + f / torch.tensor([4.0, 2.5], dtype=torch.float64)).clamp(
        -1.0, 1.0)
    (spynet_module.grid_sample(torch.from_numpy(img), grid)
     * torch.from_numpy(g)).sum().backward()
    with jax.enable_x64(True):
        ref = np.asarray(jax.grad(lambda f: jnp.sum(jspynet_warp(
            jnp.asarray(img), f) * g))(jnp.zeros((1, 6, 9, 2))))
    edge = np.zeros((6, 9), bool)
    edge[:, [0, -1]] = True
    assert np.abs(ref[0, edge, 0]).min() > 1e-6
    np.testing.assert_allclose(f.grad.numpy()[0, edge, 0],
                               2.0 * ref[0, edge, 0], rtol=1e-9)
    np.testing.assert_allclose(f.grad.numpy()[0, ~edge, 0],
                               ref[0, ~edge, 0], rtol=1e-9, atol=1e-12)


def _write_weight_dir(path, strmodel="F", levels=6, seed=0):
    """Per-layer files of the reference's layout, OIHW weights and biases,
    levels 1..`levels`."""
    gen = torch.Generator().manual_seed(seed)
    path.mkdir(parents=True, exist_ok=True)
    chans = (8, 32, 64, 32, 16, 2)
    for lvl in range(1, levels + 1):
        for j, (c_in, c_out) in enumerate(zip(chans, chans[1:]), 1):
            w = torch.randn((c_out, c_in, 7, 7), generator=gen)
            torch.save(w / (7 * np.sqrt(c_in)),
                       path / f"modelL{lvl}_{strmodel}-{j}-weight.pth.tar")
            torch.save(0.1 * torch.randn(c_out, generator=gen),
                       path / f"modelL{lvl}_{strmodel}-{j}-bias.pth.tar")


def test_spynet_loads_a_weight_directory(tmp_path, monkeypatch):
    """`load_model("SpyNet", checkpoint=dir)` reads the per-layer files
    as `pcfa_tpu` does (the same tree through the bridge, the same flow);
    the chairs models ('3', '4') reuse level 5's files for level 6."""
    monkeypatch.chdir(tmp_path)  # pcfa_tpu's msgpack cache lands here
    wdir = tmp_path / "spynet_weights"
    _write_weight_dir(wdir)
    loaded = runtime.load_model("SpyNet", checkpoint=str(wdir), device="cpu")
    state = loaded.module.state_dict()
    w = torch.load(wdir / "modelL6_F-3-weight.pth.tar", weights_only=True)
    assert torch.equal(state["moduleBasic.5.moduleBasic.4.weight"], w)
    jloaded = jruntime.load_model("SpyNet", checkpoint=str(wdir))
    want = spynet_params_from_jax(jax.tree.map(np.asarray, jloaded.params))
    assert state.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(state[k].numpy(), v.numpy(), err_msg=k)
    rng = np.random.default_rng(4)
    i1, i2 = (rng.random((1, 64, 64, 3)).astype(np.float32)
              for _ in range(2))
    with torch.no_grad():
        flow = loaded.module(torch.from_numpy(i1), torch.from_numpy(i2))
    jflow = jax.jit(lambda a, b: jloaded.module.apply(
        {"params": jax.tree.map(jnp.asarray, jloaded.params)}, a, b))(i1, i2)
    np.testing.assert_allclose(flow.numpy(), np.asarray(jflow), rtol=1e-3,
                               atol=1e-3)

    chairs = tmp_path / "chairs"
    _write_weight_dir(chairs, "3", levels=5, seed=1)
    sd = convert.spynet_state_from_files(str(chairs), "3")
    for p in ("weight", "bias"):
        for j in range(0, 10, 2):
            assert torch.equal(sd[f"moduleBasic.5.moduleBasic.{j}.{p}"],
                               sd[f"moduleBasic.4.moduleBasic.{j}.{p}"])
    jtree = spynet_params_from_files(str(chairs), "3")
    for k, v in spynet_params_from_jax(jtree).items():
        assert torch.equal(sd[k], v), k
    with pytest.raises(FileNotFoundError):
        convert.spynet_state_from_files(str(chairs), "F")


def test_spynet_missing_or_partial_directory(tmp_path, monkeypatch):
    """As `pcfa_tpu`: no directory at the default path, or one that lacks a
    file (an aborted download), raises FileNotFoundError, unless
    init_random=True, which then gives the random weights of the seed."""
    monkeypatch.chdir(tmp_path)
    assert runtime.WEIGHT_PATHS["SpyNet"].endswith("spynet_weights")
    with pytest.raises(FileNotFoundError, match="No SpyNet checkpoint"):
        runtime.load_model("SpyNet", device="cpu")
    rand = runtime.load_model("SpyNet", init_random=True, seed=0,
                              device="cpu").module.state_dict()
    wdir = tmp_path / runtime.WEIGHT_PATHS["SpyNet"]
    wdir.mkdir(parents=True)
    for partial in (False, True):
        if partial:
            _write_weight_dir(wdir, levels=3)
        with pytest.raises(FileNotFoundError, match="incomplete"):
            runtime.load_model("SpyNet", device="cpu")
        got = runtime.load_model("SpyNet", init_random=True, seed=0,
                                 device="cpu").module.state_dict()
        assert all(torch.equal(got[k], v) for k, v in rand.items())
        with pytest.raises(FileNotFoundError):
            jruntime.load_model("SpyNet")


def test_spynet_registry_runtime_and_attack():
    """SpyNet: pad divisor 64, 6 levels; random weights with flax's default
    initializers (LeCun-normal kernels by fan-in, zero biases);
    load_model → make_flow_fn → pcfa_attack on the CPU."""
    spec = get_spec("SpyNet")
    assert (spec.pad_divisor, spec.iters, spec.defaults) == (64, None,
                                                             {"nlevels": 6})
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            runtime.load_model("SpyNet", init_random=True)
    loaded = runtime.load_model("SpyNet", init_random=True, seed=0,
                                device="cpu")
    sd = loaded.module.state_dict()
    assert len(sd) == 60
    assert not any(v.any() for k, v in sd.items() if k.endswith(".bias"))
    w = sd["moduleBasic.0.moduleBasic.2.weight"]  # 32 → 64
    assert abs(float(w.std()) * np.sqrt(32 * 49) - 1.0) < 0.05

    padder, flow_fn = runtime.make_flow_fn(loaded, (60, 100), "kitti")
    assert padder.padded_shape == (64, 128)
    rng = np.random.default_rng(5)
    x1, x2 = padder.pad(*(torch.from_numpy(rng.random((1, 60, 100, 3))
                                           .astype(np.float32))
                          for _ in range(2)))
    res = pcfa_attack(flow_fn, x1, x2, torch.zeros(1, 60, 100, 2),
                      PCFAConfig(steps=1, max_iter=2), device="cpu")
    assert torch.isfinite(res.metrics.aee_adv_tgt).all()
    assert float(res.delta1.abs().max()) > 0
