"""Which input signatures `utils/graphs.GraphedNetwork` captures, on the CPU.

RAFT's spec declares `capturable`, and a RAFT instance says per input
signature whether CUDA graphs can capture it (`RAFT.graph_capturable`): not
with `remat`, not split over ranks, and only where the corr path resolves
to 'materialized'. A signature it refuses runs the module eagerly, which
the CPU can run: `GraphedNetwork` then gives the flow, the last element of
a tuple output, and captures and replays nothing. The capture itself needs
the card (`tests/test_torch_cuda.py -k graph`)."""

from __future__ import annotations

import pytest
import torch

from pcfa_tpu_torch.models import get_spec, make_model
from pcfa_tpu_torch.ops.correlation import resolve_corr_impl
from pcfa_tpu_torch.utils import graphs, profiling

#: the cells' RAFT input: KITTI padded to 376×1248
KITTI = (376, 1248)
#: twice KITTI, where 'auto' takes the fused path (PERF.md §7)
KITTI2X = (752, 2488)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape(pairs, hw):
    return (pairs, *hw, 3)


def test_only_raft_among_the_recurrent_nets_declares_capturable():
    assert get_spec("RAFT").capturable and get_spec("PWCNet").capturable
    for name in ("GMA", "RAFT-small", "SpyNet", "FlowNet2"):
        assert not get_spec(name).capturable, name


def test_twice_kitti_resolves_to_the_fused_path():
    """The premise of the refused case below: at 752×2488 'auto' takes
    'fused' for the encoder's 94×311 maps, at 376×1248 'materialized'."""
    assert resolve_corr_impl("auto", (2, 94, 311, 256), (2, 94, 311, 256),
                             4, torch.bfloat16) == "fused"
    assert resolve_corr_impl("auto", (16, 47, 156, 256), (16, 47, 156, 256),
                             4, torch.bfloat16) == "materialized"


@pytest.mark.parametrize("kwargs,pairs,hw,dtype,want", [
    ({}, 2, KITTI, torch.bfloat16, True),
    ({}, 16, KITTI, torch.bfloat16, True),
    ({}, 2, KITTI, torch.float32, True),
    ({}, 1, (128, 128), torch.float32, True),
    ({"corr_impl": "materialized"}, 2, KITTI2X, torch.bfloat16, True),
    ({"remat": True}, 2, KITTI, torch.bfloat16, False),
    ({"remat": True, "remat_policy": "dots"}, 2, KITTI, torch.bfloat16,
     False),
    ({"spatial_shards": 2}, 2, KITTI, torch.bfloat16, False),
    ({}, 2, KITTI2X, torch.bfloat16, False),
    ({"corr_impl": "fused"}, 2, KITTI, torch.bfloat16, False),
    ({"corr_impl": "hybrid"}, 2, KITTI, torch.bfloat16, False),
], ids=["b2", "b16", "b2-float32", "small", "2x-materialized", "remat",
        "remat-dots", "spatial-shards", "2x-auto-fused", "fused", "hybrid"])
def test_raft_graph_capturable(kwargs, pairs, hw, dtype, want):
    """The cells' RAFT (auto corr path, whole, no remat) is accepted at
    KITTI size for 2 and 16 pairs; remat, two spatial shards, and a corr
    path other than 'materialized', given or resolved, are refused."""
    module, _ = make_model("RAFT", **kwargs)
    s = _shape(pairs, hw)
    assert module.graph_capturable(s, s, dtype) is want


@pytest.mark.parametrize("budget_mb,impl", [("6144", "materialized"),
                                            ("0", "fused")])
def test_raft_graph_capturable_follows_the_forwards_corr_path(
        monkeypatch, budget_mb, impl):
    """The decision reads the path the forward takes: with the budget
    that makes 'auto' fuse at 128×128, the forward counts 'fused' and the
    signature is refused; with the default it counts 'materialized' and
    is accepted."""
    monkeypatch.setenv("PCFA_CORR_HBM_BUDGET_MB", budget_mb)
    module, _ = make_model("RAFT", iters=1)
    module.eval().requires_grad_(False)
    x = torch.rand((1, 128, 128, 3), generator=torch.Generator()
                   .manual_seed(0))
    before = profiling.counters()
    with torch.no_grad():
        module(x, x)
    after = profiling.counters()
    key = f"raft.corr_impl.{impl}"
    assert after.get(key, 0) - before.get(key, 0) == 1
    assert module.graph_capturable(x.shape, x.shape, x.dtype) is (
        impl == "materialized")


class _Pair(torch.nn.Module):
    """A stand-in network with a tuple output, (coarse, flow), that
    refuses or accepts every signature and records what it was asked."""

    def __init__(self, accept: bool):
        super().__init__()
        self.accept, self.asked = accept, []
        self.w = torch.nn.Parameter(torch.tensor(0.5), requires_grad=False)

    def graph_capturable(self, shape1, shape2, dtype):
        self.asked.append((tuple(shape1), tuple(shape2), dtype))
        return self.accept

    def forward(self, x1, x2):
        coarse = x1 - x2
        return coarse, (self.w * coarse * x2)[..., :2]


def test_refused_signature_runs_eagerly_and_gives_the_last_output():
    """A signature the module refuses runs it eagerly at every call, on
    inputs cast to the network's dtype: the flow is the tuple's last
    element with its gradient, the module is asked once per signature,
    and nothing is captured or replayed (no CUDA call: this runs on the
    CPU)."""
    module = _Pair(accept=False).double()
    net = graphs.GraphedNetwork(module, torch.float64, "standin")
    gen = torch.Generator().manual_seed(0)
    before = profiling.counters()
    for pairs in (2, 2, 1, 2):
        x1, x2 = (torch.rand((pairs, 8, 8, 3), generator=gen)
                  .requires_grad_(True) for _ in range(2))
        flow = net(x1, x2)
        assert flow.dtype == torch.float64 and flow.shape == (pairs, 8, 8, 2)
        want = module(x1.double(), x2.double())[-1]
        assert torch.equal(flow, want)
        g = torch.autograd.grad(flow.sum(), (x1, x2))
        g_want = torch.autograd.grad(want.sum(), (x1, x2))
        for a, b in zip(g, g_want):
            assert torch.equal(a, b)
    after = profiling.counters()
    for name in ("flow.graph_captures", "flow.graph_replays"):
        assert after.get(name, 0) == before.get(name, 0), name
    assert module.asked == [((2, 8, 8, 3), (2, 8, 8, 3), torch.float64),
                            ((1, 8, 8, 3), (1, 8, 8, 3), torch.float64)]
