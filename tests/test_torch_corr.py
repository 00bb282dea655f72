"""`pcfa_tpu_torch`'s fused and hybrid corr paths, fused GRU gates and
remat vs `pcfa_tpu` and vs the port's own materialized, unfused, no-remat
forms, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: lookup outputs in float32 at 1e-4 (sums of up to a few hundred
float32 products in another order); flows in float32 at rtol/atol 1e-3 and
input gradients in float64 at 1e-9, as tests/test_torch_raft.py holds RAFT
and says why. The fused path rounds its correlation rows to float32 in
either package (as `pcfa_tpu` does, also under float64), so the port's
fused and hybrid RAFT differ from its materialized RAFT in float64 by that
rounding: ~5e-8 at these shapes, held to 1e-6. Remat and the fused gates
change no value: they are held to 1e-9 in float64.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from pcfa_tpu.models import make_model as jmake_model
from pcfa_tpu.models.raft import SepConvGRU as JSepConvGRU
from pcfa_tpu.ops import correlation as jcorr
from pcfa_tpu_torch import runtime
from pcfa_tpu_torch.models import make_model
from pcfa_tpu_torch.models.convert import _conv, raft_params_from_jax
from pcfa_tpu_torch.models.raft import SepConvGRU
from pcfa_tpu_torch.ops import correlation


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


B, HF, WF, C = 2, 16, 16, 32   # 256 queries per pair: blocks 100, 100, 56
BLOCK = 100
H = W = 128
ITERS = 2


def _lookup_inputs(seed=0):
    rng = np.random.default_rng(seed)
    f1, f2 = (rng.standard_normal((B, HF, WF, C)) for _ in range(2))
    y, x = np.meshgrid(np.arange(HF), np.arange(WF), indexing="ij")
    coords = (np.stack([x, y], -1)[None]
              + 3.0 * rng.standard_normal((B, HF, WF, 2)))
    coords[:, ::5, ::3] += 40.0  # some queries far out of the map
    g = rng.standard_normal((B, HF, WF, 4 * 81))
    return f1, f2, coords, g


def _jax_lookup(impl, f1, f2, coords):
    if impl == "fused":
        return jcorr.corr_lookup_fused(
            f1, jcorr.f2_feature_pyramid(f2, 4), coords, 4, BLOCK)
    rest = jcorr.corr_pyramid_pooled(f1, f2, 4, start_level=1)
    return jcorr.corr_lookup_hybrid(f1, f2, rest, coords, 4, BLOCK)


@pytest.mark.parametrize("impl", ["fused", "hybrid"])
def test_corr_lookup_matches_jax(impl):
    """The lookup where the block does not divide the queries (256 in
    blocks of 100; `pcfa_tpu` pads the tail block, the port shortens it):
    outputs in float32, d fmap1 and d fmap2 of Σ out·g in float64. The
    hybrid path's levels 1..3 go through the materialized lookup with
    halved coords; against the port's lookup on the whole materialized
    pyramid it must give the same windows (level l at coords / 2ˡ)."""
    f1, f2, coords, g = _lookup_inputs()
    ref = np.asarray(jax.jit(_jax_lookup, static_argnums=0)(
        impl, *(jnp.asarray(a, jnp.float32) for a in (f1, f2, coords))))
    t1, t2, tc = (torch.tensor(a, dtype=torch.float32)
                  for a in (f1, f2, coords))
    with torch.no_grad():
        got = correlation.make_corr_lookup(impl, t1, t2, 4, 4, BLOCK)(tc)
        full = correlation.corr_lookup(
            correlation.corr_pyramid_pooled(t1, t2, 4), tc, 4)
    assert got.shape == (B, HF, WF, 4 * 81) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-4)

    with jax.enable_x64(True):
        jgrads = jax.jit(jax.grad(lambda a, b: jnp.sum(
            _jax_lookup(impl, a, b, jnp.asarray(coords)) * g), (0, 1)))(
                jnp.asarray(f1), jnp.asarray(f2))
    t1, t2 = (torch.tensor(a, requires_grad=True) for a in (f1, f2))
    look = correlation.make_corr_lookup(impl, t1, t2, 4, 4, BLOCK)
    (look(torch.tensor(coords)) * torch.tensor(g)).sum().backward()
    for got, ref in zip((t1.grad, t2.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9,
                                   atol=1e-9)
    assert np.abs(np.asarray(jgrads[1])).max() > 1.0


@pytest.mark.parametrize("budget_mb", [None, "1", "9000"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("fshape", [(2, 47, 156, 256), (1, 94, 311, 256),
                                    (2, 94, 311, 256), (2, 16, 16, 32)])
def test_resolve_corr_impl_matches_jax_over_budgets(monkeypatch, budget_mb,
                                                     dt, fshape):
    if budget_mb is None:
        monkeypatch.delenv("PCFA_CORR_HBM_BUDGET_MB", raising=False)
    else:
        monkeypatch.setenv("PCFA_CORR_HBM_BUDGET_MB", budget_mb)
    for impl in ("auto", "materialized", "fused", "hybrid"):
        ref = jcorr.resolve_corr_impl(impl, fshape, fshape, 4,
                                      getattr(jnp, dt))
        assert correlation.resolve_corr_impl(
            impl, fshape, fshape, 4, getattr(torch, dt)) == ref


def _raft(**kw):
    loaded = runtime.load_model("RAFT", init_random=True, seed=0,
                                device="cpu", iters=ITERS, **kw)
    with torch.no_grad():
        loaded.module.update_block.flow_head.conv2.weight.mul_(0.01)
        loaded.module.update_block.flow_head.conv2.bias.mul_(0.01)
    return loaded.module


def _images(dtype):
    rng = np.random.default_rng(1)
    i1, i2 = (torch.from_numpy(rng.random((1, H, W, 3))).to(dtype)
              for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((1, H, W, 2))).to(dtype)
    return i1, i2, g


def _flow_and_grads(model, dtype):
    """flow_up, and the input gradients of Σ flow_up·g, in `dtype`."""
    i1, i2, g = _images(dtype)
    a, b = i1.requires_grad_(True), i2.requires_grad_(True)
    _, up = model.to(dtype)(a, b)
    (up * g).sum().backward()
    model.to(torch.float32)
    return [t.detach().numpy() for t in (up, a.grad, b.grad)]


@pytest.fixture(scope="module")
def raft_f64_reference():
    """The port's RAFT (materialized, unfused, no remat) in float64."""
    return _flow_and_grads(_raft(corr_impl="materialized"), torch.float64)


@pytest.mark.parametrize("impl", ["fused", "hybrid"])
def test_raft_corr_impls_match_materialized(raft_f64_reference, impl):
    """RAFT with corr_block 100 (a short tail block): flows in float32 at
    1e-3; flow and input gradients in float64 at 1e-6 (the fused rows'
    float32 rounding, see the module docstring)."""
    i1, i2, _ = _images(torch.float32)
    with torch.no_grad():
        _, want = _raft(corr_impl="materialized")(i1, i2)
        _, got = _raft(corr_impl=impl, corr_block=BLOCK)(i1, i2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-3)
    out = _flow_and_grads(_raft(corr_impl=impl, corr_block=BLOCK),
                          torch.float64)
    for got, ref in zip(out, raft_f64_reference):
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def _random_tree(shapes, seed=0):
    """A JAX parameter tree of `shapes` filled from a numpy seed: LeCun-
    scaled kernels, small nonzero 1-D leaves (biases, folded BatchNorms),
    the flow head's conv2 damped ×0.01."""
    rng = np.random.default_rng(seed)

    def fill(s):
        if len(s.shape) == 4:  # HWIO: fan-in = kh·kw·I
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:3]))).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    tree = jax.tree.map(fill, shapes)
    head = tree["update_block"]["flow_head"]["conv2"]
    head["kernel"], head["bias"] = 0.01 * head["kernel"], 0.01 * head["bias"]
    return tree


def test_raft_fused_matches_jax():
    """RAFT with corr_impl='fused' and corr_block 100 against JAX RAFT with
    the same, on the same weights (the bridge): flows in float32."""
    jmodel, _ = jmake_model("RAFT", iters=ITERS, corr_impl="fused",
                            corr_block=BLOCK)
    x = jnp.zeros((1, H, W, 3))
    params = _random_tree(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                         x, x)["params"])
    tmodel, _ = make_model("RAFT", iters=ITERS, corr_impl="fused",
                           corr_block=BLOCK)
    tmodel.load_state_dict(raft_params_from_jax(params), strict=True)
    tmodel.eval().requires_grad_(False)
    i1, i2, _ = _images(torch.float32)
    with torch.no_grad():
        lr, up = tmodel(i1, i2)
    jlr, jup = jax.jit(lambda a, b: jmodel.apply({"params": params}, a, b))(
        i1.numpy(), i2.numpy())
    np.testing.assert_allclose(lr.numpy(), np.asarray(jlr), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(up.numpy(), np.asarray(jup), rtol=1e-3,
                               atol=1e-3)
    assert np.abs(np.asarray(jup)).max() > 1e-2


@pytest.mark.parametrize("variant", [
    dict(remat=True), dict(remat=True, remat_policy="dots"),
    dict(remat=True, corr_impl="hybrid", corr_block=BLOCK), "gru_fused"])
def test_remat_and_fused_gates_change_no_value(raft_f64_reference,
                                               monkeypatch, variant):
    """Flow and input gradients in float64, at 1e-9, against the port's
    RAFT without remat and with unfused gates. The hybrid case holds remat
    against hybrid without remat: its materialized levels' lookups add
    into the one set of gradient buffers built outside the checkpoints."""
    if variant == "gru_fused":
        monkeypatch.setenv("PCFA_GRU_FUSED", "1")
        variant, ref = {}, raft_f64_reference
    elif "corr_impl" in variant:
        ref = _flow_and_grads(_raft(corr_impl="hybrid", corr_block=BLOCK),
                              torch.float64)
    else:
        ref = raft_f64_reference
    out = _flow_and_grads(_raft(**{"corr_impl": "materialized", **variant}),
                          torch.float64)
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    assert np.abs(ref[1]).max() > 1e-2


class _CountConvs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.convolution.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,recomputed", [(None, True),
                                               ("dots", False)])
def test_remat_policy_recomputes(policy, recomputed):
    """Full remat reruns every iteration's convolutions in the backward;
    'dots' keeps the products' outputs and reruns none. Any other policy
    raises, as in `pcfa_tpu`."""
    model = _raft(corr_impl="materialized", remat=True, remat_policy=policy)
    i1, i2, g = _images(torch.float32)
    a = i1.requires_grad_(True)
    _, up = model(a, i2)
    count = _CountConvs()
    with count:
        (up * g).sum().backward()
    assert (count.n > 0) == recomputed
    with pytest.raises(ValueError, match="remat_policy"):
        make_model("RAFT", remat=True, remat_policy="everything")


def test_sep_conv_gru_fused_matches_unfused_and_jax(monkeypatch):
    """The fused z/r conv against the unfused gates (float64, 1e-12) and
    against `pcfa_tpu`'s SepConvGRU(fused=True) on the same weights
    (float32, 1e-5); `fused=None` reads PCFA_GRU_FUSED."""
    rng = np.random.default_rng(2)
    hidden, inp = 16, 24
    h = rng.standard_normal((2, 6, 10, hidden))
    x = rng.standard_normal((2, 6, 10, inp))
    jgru = JSepConvGRU(hidden, fused=True)
    params = jax.tree.map(np.asarray, jgru.init(
        jax.random.PRNGKey(3), jnp.asarray(h, jnp.float32),
        jnp.asarray(x, jnp.float32))["params"])
    params = jax.tree.map(lambda v: v + 0.1 * rng.standard_normal(v.shape)
                          .astype(np.float32), params)  # nonzero biases
    sd = {}
    for k, leaf in params.items():
        _conv(sd, k, leaf)
    tgru = SepConvGRU(hidden, inp)
    tgru.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()})

    def run(dtype, **kw):
        th, tx = (torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2)
                  for a in (h, x))
        for k, v in kw.items():
            setattr(tgru, k, v)
        with torch.no_grad():
            out = tgru.to(dtype)(th, tx).permute(0, 2, 3, 1)
        tgru.to(torch.float32)
        return out.numpy()

    assert SepConvGRU(hidden, inp, fused=False).gate_weights() is None
    fused64 = run(torch.float64, fused=True)
    np.testing.assert_allclose(fused64, run(torch.float64, fused=False),
                               rtol=1e-12, atol=1e-12)
    ref = np.asarray(jgru.apply({"params": params},
                                jnp.asarray(h, jnp.float32),
                                jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(run(torch.float32, fused=True), ref,
                               rtol=1e-5, atol=1e-5)
    monkeypatch.setenv("PCFA_GRU_FUSED", "1")
    tgru.fused = None
    assert set(tgru.gate_weights()) == {"1", "2"}
    np.testing.assert_array_equal(run(torch.float64), fused64)
