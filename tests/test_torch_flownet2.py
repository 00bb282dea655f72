"""`pcfa_tpu_torch` FlowNet2 vs `pcfa_tpu` FlowNet2 on the CPU, through
the weight bridge `flownet2_params_from_jax`; its warp (`resample2d`),
`channel_norm` and the transposed convs run as one 3×3 conv.

Weights: the JAX tree's shapes (from `eval_shape`, no compile of `init`),
filled from a numpy seed with LeCun-scaled kernels (fan-in: taps × input
channels, transposed kernels too) and small nonzero biases. One pair at
64×128.

Flows are compared in float32 at rtol/atol 1e-3; in float64 the flow and
the input gradients of Σ flow·g at 1e-9. The JAX package's packed warp VJP
computes in float32 even under x64, so its float64 run takes its 4-corner
reference VJP (`PCFA_WARP_VJP=reference`), as tests/test_torch_spynet.py
does. Its bilinear resize matrices are float32 too, but FlowNet2's ×4
align_corners=False weights (⅛, ⅜, ⅝, ⅞) are exact in float32.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pcfa_tpu.models import make_model as jmake_model
from pcfa_tpu.models.flownet2 import _DeconvP
from pcfa_tpu.ops.channelnorm import channel_norm as jchannel_norm
from pcfa_tpu.ops.warp import resample2d as jresample2d
from pcfa_tpu_torch import runtime
from pcfa_tpu_torch.models import convert, get_spec, make_model
from pcfa_tpu_torch.models import flownet2 as fn2
from pcfa_tpu_torch.ops import warp as warp_module
from pcfa_tpu_torch.ops.channelnorm import channel_norm
from pcfa_tpu_torch.ops.warp import resample2d

N_PARAMS = 162_518_834  # 'Parameter count' of the reference (COMPONENTS.md)
H, W = 64, 128


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


def _fill(rng):
    def fill(s):
        if len(s.shape) == 4:  # HWIO: fan-in = kh·kw·I
            return (rng.standard_normal(s.shape, np.float32)
                    / np.sqrt(np.prod(s.shape[:3]))).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return fill


@pytest.fixture(scope="module")
def nets():
    jmodel, _ = jmake_model("FlowNet2")
    x = jnp.zeros((1, H, W, 3))
    params = jax.tree.map(_fill(np.random.default_rng(0)), jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), x, x)["params"])
    tmodel, _ = make_model("FlowNet2")
    tmodel.load_state_dict(convert.flownet2_params_from_jax(params),
                           strict=True)
    tmodel.eval().requires_grad_(False)
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(1)
    i1, i2 = (rng.random((1, H, W, 3)) for _ in range(2))
    return i1, i2, rng.standard_normal((1, H, W, 2))


def test_flownet2_parameter_count(nets):
    """162,518,834 parameters on both sides, 220 tensors."""
    _, params, tmodel = nets
    assert sum(a.size for a in jax.tree.leaves(params)) == N_PARAMS
    sd = tmodel.state_dict()
    assert len(sd) == 220
    assert sum(v.numel() for v in sd.values()) == N_PARAMS
    assert "flownets_1.upsampled_flow6_to_5.bias" not in sd
    assert "flownetc.upsampled_flow6_to_5.bias" in sd


def test_flownet2_matches_jax(nets, pair, monkeypatch):
    """Float32 flow at rtol/atol 1e-3; float64 flow and input gradients of
    Σ flow·g at 1e-9."""
    jmodel, params, tmodel = nets
    i1, i2, g = pair
    jflow = np.asarray(jax.jit(lambda a, b: jmodel.apply(
        {"params": jax.tree.map(jnp.asarray, params)}, a, b))(
            i1.astype(np.float32), i2.astype(np.float32)))
    with torch.no_grad():
        flow = tmodel(*(torch.from_numpy(a).float() for a in (i1, i2)))
    assert flow.shape == (1, H, W, 2) and flow.dtype == torch.float32
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
        del p, grads
    a, b = (torch.from_numpy(x).requires_grad_(True) for x in (i1, i2))
    out = tmodel.double()(a, b)
    (out * torch.from_numpy(g)).sum().backward()
    tmodel.float()
    for got, want in zip((out.detach(), a.grad, b.grad), ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)
    assert np.abs(ref[2]).max() > 1e-2  # frame 2's gradient is not trivial


def test_flownet2_bf16_routes_and_dtypes(nets, pair, monkeypatch):
    """41 small convs per forward (14 `CL`, 7 `PlainConv`, 20 deconvs as
    one 3×3 conv each), all with bf16 inputs under bf16 compute; the
    patch correlation on bf16 maps; four warps of the bf16 image with
    float32 flows; the flow back in float32, near the float32 flow."""
    tmodel = nets[2]
    seen = {"conv": [], "warp": [], "corr": []}
    conv, sample = fn2.small_conv2d, warp_module._PackedBilinear.apply
    corr = fn2.local_corr

    def conv_spy(x, w, *args):
        seen["conv"].append((x.dtype, tuple(w.shape)))
        return conv(x, w, *args)

    def warp_spy(img, ix, iy, zeros):
        seen["warp"].append((img.dtype, ix.dtype, zeros))
        return sample(img, ix, iy, zeros)

    def corr_spy(f1, f2, patch, stride):
        seen["corr"].append((f1.dtype, patch, stride))
        return corr(f1, f2, patch, stride)

    monkeypatch.setattr(fn2, "small_conv2d", conv_spy)
    monkeypatch.setattr(fn2, "local_corr", corr_spy)
    monkeypatch.setattr(warp_module._PackedBilinear, "apply", warp_spy)
    loaded = runtime.LoadedModel("FlowNet2", tmodel, get_spec("FlowNet2"),
                                 torch.device("cpu"))
    x1, x2 = (torch.from_numpy(a).float() for a in pair[:2])
    ref = runtime.make_flow_fn(loaded, (H, W))[1](x1, x2)
    assert len(seen["conv"]) == 41
    combined = {(8, 2, 3, 3), (128, 128, 3, 3), (64, 162, 3, 3)}
    assert sum(s in combined for _, s in seen["conv"]) == 20
    for v in seen.values():
        v.clear()
    monkeypatch.setenv("PCFA_COMPUTE_DTYPE", "bfloat16")
    flow = runtime.make_flow_fn(loaded, (H, W))[1](x1, x2)
    assert [d for d, _ in seen["conv"]] == [torch.bfloat16] * 41
    assert seen["corr"] == [(torch.bfloat16, 21, 2)]
    assert seen["warp"] == [(torch.bfloat16, torch.float32, False)] * 4
    assert flow.dtype == torch.float32 and torch.isfinite(flow).all()
    assert float((flow - ref).abs().max()) < 0.1 * float(ref.abs().max())


def test_resample2d_and_channel_norm_match_jax(monkeypatch):
    """float64, against JAX's 4-corner reference VJP: the value and the
    gradients of Σ out·g to the image and the flow, with samples far
    outside the image, on exact integers and exactly on its border
    (the per-corner clamp); `channel_norm` and its gradient."""
    rng = np.random.default_rng(2)
    B, h, w, c = 2, 7, 9, 3
    img = rng.standard_normal((B, h, w, c))
    flow = 2.0 * rng.standard_normal((B, h, w, 2))
    flow[0, 0, 0] = [-50.0, 3e3]                  # far outside
    flow[0, 1, :, 0] = np.round(flow[0, 1, :, 0])  # exact integers
    flow[0, 2, :] = 0.0                           # on the pixel grid
    flow[1, :, 0, 0] = 0.0                        # x on the left edge
    flow[1, 0, :, 1] = 0.0                        # y on the top edge
    flow[1, :, -1, 0] = 0.0                       # x on the right edge
    flow[1, 3, 4] = [w - 1 - 4.0, h - 1 - 3.0]     # the bottom-right corner
    g = rng.standard_normal((B, h, w, c))
    monkeypatch.setenv("PCFA_WARP_VJP", "reference")
    with jax.enable_x64(True):
        jout, jvjp = jax.vjp(jresample2d, jnp.asarray(img),
                             jnp.asarray(flow))
        ref = [np.asarray(v) for v in (jout, *jvjp(jnp.asarray(g)))]
        nout, nvjp = jax.vjp(jchannel_norm, jnp.asarray(img))
        nref = [np.asarray(nout), np.asarray(nvjp(jnp.asarray(
            g[..., :1]))[0])]
    a, f = (torch.from_numpy(x).requires_grad_(True) for x in (img, flow))
    out = resample2d(a, f)
    (out * torch.from_numpy(g)).sum().backward()
    assert out.dtype == torch.float64
    for got, want in zip((out.detach(), a.grad, f.grad), ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_allclose(out[0, 0, 0].detach().numpy(),
                               img[0, -1, 0], rtol=1e-12)
    t = torch.from_numpy(img).requires_grad_(True)
    n = channel_norm(t)
    (n * torch.from_numpy(g[..., :1])).sum().backward()
    np.testing.assert_allclose(n.detach().numpy(), nref[0], rtol=1e-12)
    np.testing.assert_allclose(t.grad.numpy(), nref[1], rtol=1e-12,
                               atol=1e-12)
    # with eps 0 the norm's gradient at an exact zero is NaN on both sides
    z = torch.zeros((1, 1, 1, 3), dtype=torch.float64, requires_grad=True)
    channel_norm(z).sum().backward()
    assert torch.isnan(z.grad).all()


def test_resample2d_grid_stays_float32_under_bf16():
    """A bf16 image and a float32 flow at 1280 wide: the sample positions
    keep the flow's float32 precision (the JAX package's bf16 grid would
    round x > 256) and the warp returns float32."""
    img = torch.arange(1280, dtype=torch.float32).expand(1, 2, 1280)
    img = img[..., None].to(torch.bfloat16)
    flow = torch.zeros((1, 2, 1280, 2))
    flow[..., 0] = 0.25
    out = resample2d(img.float(), flow)
    got = resample2d(img, flow)
    assert got.dtype == torch.float32
    want = img.float()[..., :-1, 0] * 0.75 + img.float()[..., 1:, 0] * 0.25
    torch.testing.assert_close(out[..., :-1, 0], want)
    torch.testing.assert_close(got, out)


@pytest.mark.parametrize("c_in,c_out,bias,act", [
    (2, 2, True, None),       # a flow upsampler (the combined 2 -> 8)
    (2, 2, False, None),      # FlowNetS's, without bias
    (128, 32, True, "leaky"),  # Fusion's deconv1 (128 -> 128)
    (162, 16, True, "leaky"),  # Fusion's deconv0 (162 -> 64)
])
def test_deconv_as_one_3x3_conv(c_in, c_out, bias, act):
    """The transposed conv routed as one stride-1 3×3 `small_conv2d` with
    4·C_out outputs and `pixel_shuffle` (the plain version on the CPU)
    against `F.conv_transpose2d` and against JAX's `_DeconvP` on XLA, in
    float64; the combined weight is built once per weight tensor and
    again when the weight changes dtype or is written in place."""
    rng = np.random.default_rng(c_in + c_out)
    x = rng.standard_normal((2, 5, 7, c_in))
    kern = rng.standard_normal((4, 4, c_in, c_out)) / np.sqrt(16 * c_in)
    b = 0.1 * rng.standard_normal(c_out)
    m = fn2.Deconv(c_in, c_out, bias=bias, act=act).double()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(convert.conv_transpose_weight(kern)))
        if bias:
            m.bias.copy_(torch.from_numpy(b))
    m.requires_grad_(False)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = m(xt)
    want = F.conv_transpose2d(xt, m.weight, m.bias, 2, 1)
    if act == "leaky":
        want = F.leaky_relu(want, 0.1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)
    leaf = {"kernel": kern, **({"bias": b} if bias else {})}
    with jax.enable_x64(True):
        jout = _DeconvP(c_out, use_bias=bias, act=act).apply(
            {"params": leaf}, jnp.asarray(x))
        jout = np.asarray(jout)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), jout,
                               rtol=1e-12, atol=1e-12)
    # the combined weight is kept, and rebuilt when the weight changes
    w3, _ = m.combined()
    assert m.combined()[0] is w3
    assert w3.shape == (4 * c_out, c_in, 3, 3)
    assert int((w3 != 0).sum()) == 4 * c_in * c_out * 4
    with torch.no_grad():
        m.weight.mul_(2.0)
    assert m.combined()[0] is not w3
    torch.testing.assert_close(m.combined()[0], 2.0 * w3)
    assert m.float().combined()[0].dtype == torch.float32


def test_flownet2_registry_and_bridge(nets):
    """FlowNet2: pad divisor 64, its default checkpoint path; the
    reference's keys pass through `flownet2_state_from_torch` as they
    are."""
    spec = get_spec("FlowNet2")
    assert (spec.pad_divisor, spec.iters) == (64, None)
    assert runtime.WEIGHT_PATHS["FlowNet2"].endswith(
        "FlowNet2_checkpoint.pth.tar")
    sd = nets[2].state_dict()
    out = convert.flownet2_state_from_torch(sd)
    assert out.keys() == sd.keys()
    assert all(out[k] is v for k, v in sd.items())
