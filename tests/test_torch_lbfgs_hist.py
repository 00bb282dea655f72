"""The L-BFGS history's compact-direction passes (`pcfa_tpu_torch/ops/
lbfgs_hist.py`) on the CPU: the plain versions the CPU path runs, the
dispatch, the checks the kernel wrappers make before a launch, and the
slab plan. The kernels themselves are held against these plain versions on
the card (`tests/test_torch_cuda.py`).

float64 cases compare with a float64 einsum over the same rows: sums of
at most ~12,300 products in another order, so 1e-12 of the values' scale.
"""

import numpy as np
import pytest
import torch

from pcfa_tpu_torch.ops import lbfgs_hist as lh


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op torch thread while this module runs (the suite runs a
    pytest worker per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


M = 5
COUNTS = [0, 3, 5, 12]        # empty, partial, full and wrapped rings
N_ODD = 4096 * 3 + 5          # not a multiple of 8


def _ring(rng, n, dtype=torch.float64, counts=COUNTS, garbage=True):
    """S, Y (B, M, n) and g, y, s (B, n) in float64 from the seed; with
    `garbage`, the rows past each pair's fill hold values (the optimizer
    keeps zeros there) that the passes must not take."""
    B = len(counts)
    S, Y = (torch.from_numpy(rng.standard_normal((B, M, n))) for _ in "SY")
    vecs = [torch.from_numpy(rng.standard_normal((B, n))) for _ in "gys"]
    count = torch.tensor(counts, dtype=torch.int64)
    valid = lh._valid(count, M)
    if not garbage:
        S, Y = (torch.where(valid[..., None], t, 0.0) for t in (S, Y))
    return S.to(dtype), Y.to(dtype), vecs, count, valid


def _close(got, ref, tol):
    scale = float(ref.abs().max()) or 1.0
    err = float((got - ref).abs().max())
    assert err <= tol * scale, f"max abs err {err} > {tol} × {scale}"


def _einsum_products(S, Y, vecs, valid):
    g, y, s = vecs
    prods = torch.stack([torch.einsum("bmn,bn->bm", S, g),
                         torch.einsum("bmn,bn->bm", S, y),
                         torch.einsum("bmn,bn->bm", Y, g),
                         torch.einsum("bmn,bn->bm", Y, y),
                         torch.einsum("bmn,bn->bm", Y, s)], dim=1)
    return torch.where(valid[:, None], prods, 0.0)


@pytest.mark.parametrize("n", [N_ODD, 4096])
def test_products_partial_ring_equal_the_zeroed_full_ring(rng, n):
    """Per-pair fills of 0, 3, 5 and 12 of 5 rows: the products equal the
    full-ring products with the rows past the fill zeroed, whatever those
    rows hold, and a float64 einsum; 0 on the rows past the fill."""
    S, Y, vecs, count, valid = _ring(rng, n)
    got = lh.hist_products_plain(S, Y, *vecs, count)
    assert got.shape == (len(COUNTS), 5, M) and got.dtype == torch.float64
    zs, zy = (torch.where(valid[..., None], t, 0.0) for t in (S, Y))
    full = torch.full_like(count, M)
    assert torch.equal(got, lh.hist_products_plain(zs, zy, *vecs, full))
    _close(got, _einsum_products(zs, zy, vecs, valid), 1e-12)
    assert torch.count_nonzero(got[0]) == 0
    assert torch.count_nonzero(got[1, :, 3:]) == 0


def test_products_round_the_vectors_to_the_history_dtype(rng):
    """bf16 history: g, y, s are rounded to bf16 before the products, which
    accumulate in float32."""
    S, Y, vecs, count, valid = _ring(rng, N_ODD, torch.bfloat16,
                                     garbage=False)
    vecs = [v.float() for v in vecs]
    got = lh.hist_products_plain(S, Y, *vecs, count)
    assert got.dtype == torch.float32
    rounded = [v.to(torch.bfloat16).double() for v in vecs]
    ref = _einsum_products(S.double(), Y.double(), rounded, valid)
    # float32 sums of ~12,300 exact products: 1e-5 of the scale
    _close(got.double(), ref, 1e-5)
    unrounded = _einsum_products(S.double(), Y.double(),
                                 [v.double() for v in vecs], valid)
    assert float((got.double() - unrounded).abs().max()) > 1e-3 * float(
        unrounded.abs().max())


@pytest.mark.parametrize("n", [N_ODD, 4096])
def test_combine_is_the_negated_compact_sum(rng, n):
    """−(γ·g + Σ top·S + γ·Σ bot·Y) over the valid rows: the rows past the
    fill, and their coefficients, do not count."""
    S, Y, vecs, count, valid = _ring(rng, n)
    g = vecs[0]
    top = torch.from_numpy(rng.standard_normal((len(COUNTS), M)))
    bot = torch.from_numpy(rng.standard_normal((len(COUNTS), M)))
    gamma = torch.from_numpy(rng.uniform(0.5, 2.0, len(COUNTS)))
    got = lh.hist_combine_plain(S, Y, g, top, bot, gamma, count)
    assert got.shape == g.shape and got.dtype == torch.float64
    tz, bz = torch.where(valid, top, 0.0), torch.where(valid, bot, 0.0)
    ref = -(gamma[:, None] * g + lh._hist_combine(tz, S)
            + gamma[:, None] * lh._hist_combine(bz, Y))
    assert torch.equal(got, ref)
    direct = -(gamma[:, None] * g + torch.einsum("bm,bmn->bn", tz, S)
               + gamma[:, None] * torch.einsum("bm,bmn->bn", bz, Y))
    _close(got, direct, 1e-12)
    _close(got[0], -gamma[0] * g[0], 0.0)


def test_combine_casts_a_bf16_history_chunk_by_chunk(rng):
    """A bf16 ring with float32 coefficients: the sum in float32 of the
    ring's exact values, chunk by chunk past `_CHUNK` columns."""
    n = lh._CHUNK + 24
    S, Y, vecs, count, valid = _ring(rng, n, torch.bfloat16, counts=[2, 7],
                                     garbage=False)
    g = vecs[0].float()
    top, bot = (torch.from_numpy(rng.standard_normal((2, M))).float()
                for _ in "tb")
    gamma = torch.tensor([0.7, 1.3])
    got = lh.hist_combine_plain(S, Y, g, top, bot, gamma, count)
    assert got.dtype == torch.float32
    tz, bz = torch.where(valid, top, 0.0), torch.where(valid, bot, 0.0)
    ref = -(gamma[:, None].double() * g.double()
            + torch.einsum("bm,bmn->bn", tz.double(), S.double())
            + gamma[:, None].double()
            * torch.einsum("bm,bmn->bn", bz.double(), Y.double()))
    _close(got.double(), ref, 1e-6)


def test_cpu_tensors_take_the_plain_versions(rng, monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU tensor reached a kernel wrapper")

    monkeypatch.setattr(lh, "hist_products_cuda", refuse)
    monkeypatch.setattr(lh, "hist_combine_cuda", refuse)
    S, Y, vecs, count, _ = _ring(rng, 64)
    assert torch.equal(lh.hist_products(S, Y, *vecs, count),
                       lh.hist_products_plain(S, Y, *vecs, count))
    top = bot = torch.ones((len(COUNTS), M), dtype=torch.float64)
    gamma = torch.ones(len(COUNTS), dtype=torch.float64)
    assert torch.equal(lh.hist_combine(S, Y, vecs[0], top, bot, gamma, count),
                       lh.hist_combine_plain(S, Y, vecs[0], top, bot, gamma,
                                             count))



def test_a_cpu_direction_is_not_counted_as_a_kernel_direction(rng):
    """The wrappers' `.launches` count the kernels' launches only: compact
    iterations on the CPU count as iterations and launch nothing."""
    from pcfa_tpu_torch.attack import lbfgs
    from pcfa_tpu_torch.utils import profiling

    a = torch.from_numpy(rng.uniform(1.0, 20.0, (2, 64)))

    def vg(x):
        return 0.5 * (a * x * x).sum(1), a * x

    state = lbfgs.lbfgs_init(torch.ones((2, 64), dtype=torch.float64), M)
    before = profiling.counters()
    launches = lh.hist_products_cuda.launches, lh.hist_combine_cuda.launches
    for it in range(3):
        state, _ = lbfgs.lbfgs_iteration(vg, state, it, direction="compact")
    after = profiling.counters()
    assert after["lbfgs.iterations"] - before.get("lbfgs.iterations", 0) \
        == 3
    assert (lh.hist_products_cuda.launches,
            lh.hist_combine_cuda.launches) == launches

def _bad(case, S, Y, vecs, count):
    """One input the kernels do not take."""
    g, y, s = vecs
    if case == "half_history":
        S, Y = S.half(), Y.half()
    elif case == "mixed_history":
        Y = Y.float()
    elif case == "strided_history":
        S = S.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "bf16_vector":
        g = g.to(torch.bfloat16)
    elif case == "mixed_vectors":
        y = y.float()
    elif case == "short_vector":
        s = s[:, :-1]
    elif case == "int32_count":
        count = count.int()
    elif case == "long_history":
        S = Y = torch.zeros((1, lh._MAX_HISTORY + 1, 8), dtype=S.dtype)
        g = y = s = torch.zeros((1, 8), dtype=g.dtype)
        count = torch.zeros(1, dtype=torch.int64)
    elif case == "odd_n":
        S, Y, g, y, s = (t[..., :60].contiguous() for t in (S, Y, g, y, s))
    elif case == "misaligned":
        flat = torch.empty(S.numel() + 1, dtype=S.dtype)
        S = flat[1:].view(S.shape).copy_(S)     # 8 bytes past the base
    return S, Y, [g, y, s], count


# what the wrappers say of an input outside the kernels' one layout
LAYOUT = {"odd_n": "n = 60 is not a multiple of 8",
          "misaligned": "S is not 16-byte aligned"}


@pytest.mark.parametrize("case", ["half_history", "mixed_history",
                                  "strided_history", "bf16_vector",
                                  "mixed_vectors", "short_vector",
                                  "int32_count", "long_history", *LAYOUT])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(rng, case):
    """Checked before any launch, so a CPU tensor shows it. An n or a
    buffer outside the kernels' 16-byte pieces: both wrappers refuse it,
    naming which."""
    S, Y, vecs, count, _ = _ring(rng, 64)
    S, Y, vecs, count = _bad(case, S, Y, vecs, count)
    with pytest.raises(ValueError, match=LAYOUT.get(case)):
        lh.hist_products_cuda(S, Y, *vecs, count)
    if case in LAYOUT:
        top = torch.zeros((len(COUNTS), M), dtype=torch.float64)
        gamma = torch.ones(len(COUNTS), dtype=torch.float64)
        with pytest.raises(ValueError, match=LAYOUT[case]):
            lh.hist_combine_cuda(S, Y, vecs[0], top, top, gamma, count)


def test_combine_wrapper_refuses_coefficients_of_another_dtype(rng):
    S, Y, vecs, count, _ = _ring(rng, 64)
    top = torch.zeros((len(COUNTS), M), dtype=torch.float32)
    gamma = torch.ones(len(COUNTS), dtype=torch.float64)
    with pytest.raises(ValueError):
        lh.hist_combine_cuda(S, Y, vecs[0], top, top.double(), gamma, count)


def test_pieces_need_a_multiple_of_8_and_16_byte_alignment():
    """The kernels' one layout: `_check` takes a ring of whole 16-byte
    pieces, and names the n, or the buffer, that is not."""
    buf = torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)
    count = torch.zeros(1, dtype=torch.int64)

    def check(S, Y):
        vecs = [torch.zeros((1, S.shape[-1])) for _ in "gys"]
        return lh._check(S, Y, vecs, count, "history")

    whole = buf[:4 * 64].view(1, 4, 64)
    assert check(whole, whole) == (1, 4, 64)
    odd = buf[:240].view(1, 4, 60)
    with pytest.raises(ValueError, match="n = 60 is not a multiple of 8"):
        check(odd, odd)
    offset = buf[1:4 * 64 + 1].view(1, 4, 64)     # 2 bytes past the base
    assert offset.is_contiguous()
    with pytest.raises(ValueError, match="Y is not 16-byte aligned"):
        check(whole, offset)


@pytest.mark.parametrize("B,n", [(16, 2 * 3 * 376 * 1248),
                                 (2, 2 * 3 * 376 * 1248), (1, N_ODD),
                                 (3, 40), (700, 4096)])
@pytest.mark.parametrize("resident", [528, 1056])
def test_slab_plan_covers_the_columns_in_16_byte_pieces(B, n, resident):
    slabs, per = lh.plan_slabs(B, n, resident)
    assert per % 8 == 0 and per >= 256
    assert (slabs - 1) * per < n <= slabs * per
    assert slabs <= max(1, lh._WAVES * resident // B)
    if n >= 1 << 20:   # the KITTI shapes fill the waves within 1%
        assert slabs * B >= 0.99 * lh._WAVES * resident
