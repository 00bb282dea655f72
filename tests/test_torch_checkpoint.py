"""Checkpoint loading: `pcfa_tpu_torch.runtime.load_model(name,
checkpoint=...)` against `pcfa_tpu.runtime.load_model` on the same file.

The repository holds no pretrained weights, so each test writes a file in
the layout the reference ships, with `torch.save`, from a random state of
the port's network: RAFT, GMA and RAFT-small as a DataParallel state
(every key prefixed `module.`), PWCNet and FlowNet2 wrapped as
`{'state_dict': …}`, PWCNet's with the unused `deconv2` the reference
builds. Every BatchNorm is expanded to weight,
bias, running mean, running variance (positive) and `num_batches_tracked`;
GMA's file holds the relative-position tables of every shipped file. The
flow head's conv2 is damped ×0.01 and GMA's `gamma` set to 0.5, as the
parity tests do. Both packages load the file; their weights must agree
(through the bridge) and so must their flows, in float32 at rtol/atol
1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcfa_tpu import runtime as jruntime
from pcfa_tpu_torch import runtime
from pcfa_tpu_torch.models import convert, make_model


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


# name: (constructor overrides, image side, bridge from the JAX tree)
NETS = {
    "RAFT": ({"iters": 2}, 128, convert.raft_params_from_jax),
    "GMA": ({"iters": 2}, 128, convert.gma_params_from_jax),
    "PWCNet": ({}, 64, convert.pwcnet_params_from_jax),
    "RAFT-small": ({"iters": 2}, 128, convert.raft_small_params_from_jax),
    "FlowNet2": ({}, 64, convert.flownet2_params_from_jax),
}


def _shipped_state(name, seed=0) -> dict[str, torch.Tensor]:
    """A random state of the port's `name` in the reference's key layout."""
    module = runtime.init_random_(make_model(name, **NETS[name][0])[0],
                                  seed)
    gen = torch.Generator().manual_seed(seed + 1)
    sd = {}
    for k, v in module.state_dict().items():
        if k.endswith(".scale"):
            stem, c = k.removesuffix(".scale"), v.shape
            sd[f"{stem}.weight"] = 1.0 + 0.2 * torch.randn(c, generator=gen)
            sd[f"{stem}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
            sd[f"{stem}.running_var"] = 0.5 + torch.rand(c, generator=gen)
            sd[f"{stem}.num_batches_tracked"] = torch.tensor(1000)
        elif k.endswith(".bias"):
            sd[k] = 0.05 * torch.randn(v.shape, generator=gen)
        else:
            sd[k] = v.clone()
    if name in ("RAFT", "GMA", "RAFT-small"):
        for p in ("weight", "bias"):
            sd[f"update_block.flow_head.conv2.{p}"] *= 0.01
    if name == "GMA":
        sd["update_block.aggregator.gamma"] = torch.tensor([0.5])
        for t in ("rel_height", "rel_width"):
            sd[f"att.pos_emb.{t}.weight"] = torch.randn(319, 128,
                                                        generator=gen)
    if name == "PWCNet":
        sd["deconv2.weight"] = torch.randn(2, 2, 4, 4, generator=gen)
        sd["deconv2.bias"] = torch.zeros(2)
    return sd


def _save_shipped(name, path, sd):
    if name in ("PWCNet", "FlowNet2"):
        torch.save({"state_dict": sd}, path)
    else:
        torch.save({f"module.{k}": v for k, v in sd.items()}, path)


@pytest.mark.parametrize("name", list(NETS))
def test_load_model_matches_jax_on_a_shipped_file(name, tmp_path,
                                                  monkeypatch):
    kw, side, bridge = NETS[name]
    path = tmp_path / f"{name}.pth"
    _save_shipped(name, path, _shipped_state(name))
    monkeypatch.chdir(tmp_path)  # pcfa_tpu's msgpack cache lands here

    loaded = runtime.load_model(name, checkpoint=str(path), device="cpu",
                                **kw)
    jloaded = jruntime.load_model(name, checkpoint=str(path), **kw)
    state = loaded.module.state_dict()
    assert not any(k.startswith(("deconv2.", "att.pos_emb.")) for k in state)
    want = bridge(jax.tree.map(np.asarray, jloaded.params))
    assert state.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)

    rng = np.random.default_rng(3)
    i1, i2 = (rng.random((1, side, side, 3)).astype(np.float32)
              for _ in range(2))
    with torch.no_grad():
        out = loaded.module(torch.from_numpy(i1), torch.from_numpy(i2))
    jout = jax.jit(lambda a, b: jloaded.module.apply(
        {"params": jax.tree.map(jnp.asarray, jloaded.params)}, a, b))(i1, i2)
    up, jup = ((o[-1] if isinstance(o, tuple) else o) for o in (out, jout))
    np.testing.assert_allclose(up.numpy(), np.asarray(jup), rtol=1e-3,
                               atol=1e-3)
    assert np.abs(np.asarray(jup)).max() > 1e-2


def test_gma_keeps_position_tables_for_positional_attention(tmp_path):
    """GMA's reader keeps `att.pos_emb.*` for a positional variant, which
    then holds the file's tables."""
    sd = _shipped_state("GMA")
    path = tmp_path / "gma.pth"
    _save_shipped("GMA", path, sd)
    loaded = runtime.load_model("GMA", checkpoint=str(path), device="cpu",
                                position_and_content=True)
    got = loaded.module.state_dict()["att.pos_emb.rel_width.weight"]
    assert torch.equal(got, sd["att.pos_emb.rel_width.weight"])


def test_load_model_default_paths(tmp_path, monkeypatch):
    """Without `checkpoint`, `WEIGHT_PATHS[name]` under the working
    directory: absent, FileNotFoundError unless init_random=True; present,
    it is loaded. An explicit path wins, and an explicit missing path
    raises too. RAFT-small has no default path and SpyNet's directory is
    absent: FileNotFoundError, and each loads with init_random=True.
    A name that is not registered raises a KeyError naming the ported
    ones."""
    monkeypatch.chdir(tmp_path)
    for name in NETS:
        with pytest.raises(FileNotFoundError, match="init_random=True"):
            runtime.load_model(name, device="cpu")
    with pytest.raises(FileNotFoundError, match="missing.pth"):
        runtime.load_model("RAFT", checkpoint="missing.pth", device="cpu")
    rand = runtime.load_model("RAFT", init_random=True, seed=0, device="cpu")

    sd = _shipped_state("RAFT", seed=5)
    default = tmp_path / runtime.WEIGHT_PATHS["RAFT"]
    default.parent.mkdir(parents=True)
    _save_shipped("RAFT", default, sd)
    for kw in ({}, {"init_random": True}):
        got = runtime.load_model("RAFT", device="cpu", **kw).module
        key = "fnet.conv1.weight"
        assert torch.equal(got.state_dict()[key], sd[key])
        assert not torch.equal(got.state_dict()[key],
                               rand.module.state_dict()[key])
    other = tmp_path / "other.pth"
    _save_shipped("RAFT", other, _shipped_state("RAFT", seed=6))
    got = runtime.load_model("RAFT", checkpoint=str(other), device="cpu")
    assert not torch.equal(got.module.state_dict()["fnet.conv1.weight"],
                           sd["fnet.conv1.weight"])
    for name in ("SpyNet", "RAFT-small"):
        with pytest.raises(FileNotFoundError, match="init_random=True"):
            runtime.load_model(name, device="cpu")
        kw = {"iters": 1} if name == "RAFT-small" else {}
        assert runtime.load_model(name, init_random=True, device="cpu",
                                  **kw).name == name
    with pytest.raises(KeyError, match="SpyNet"):
        runtime.load_model("FlowNetX", device="cpu")
