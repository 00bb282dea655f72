"""Flow networks as `nn.Module`s plus the model registry: RAFT, GMA,
PWCNet, RAFT-small, SpyNet and FlowNet2."""

from __future__ import annotations

from pcfa_tpu_torch.models import convert
from pcfa_tpu_torch.models.flownet2 import FlowNet2
from pcfa_tpu_torch.models.gma import GMA
from pcfa_tpu_torch.models.pwcnet import PWCDCNet
from pcfa_tpu_torch.models.raft import RAFT
from pcfa_tpu_torch.models.raft_small import RAFTSmall
from pcfa_tpu_torch.models.spec import (
    ModelSpec,
    available_models,
    get_spec,
    register,
)
from pcfa_tpu_torch.models.spynet import SpyNet

register(
    ModelSpec(
        name="RAFT",
        pad_divisor=8,
        iters=12,
        make=RAFT,
        convert=convert.state_from_torch,
        defaults={"iters": 12},
    )
)

register(
    ModelSpec(
        name="GMA",
        pad_divisor=8,
        iters=6,  # the reference's adapter runs GMA with 6 iterations
        make=GMA,
        convert=convert.gma_state_from_torch,
        defaults={"iters": 6},
    )
)

register(ModelSpec(name="PWCNet", pad_divisor=64, make=PWCDCNet,
                   convert=convert.pwcnet_state_from_torch))

register(
    ModelSpec(
        name="RAFT-small",
        pad_divisor=8,
        iters=12,
        make=RAFTSmall,
        convert=convert.raft_small_state_from_torch,
        defaults={"iters": 12},
    )
)


def _read_spynet(path: str, module: SpyNet) -> dict:
    return convert.spynet_state_from_files(path, nlevels=module.nlevels)


register(ModelSpec(name="SpyNet", pad_divisor=64, make=SpyNet,
                   read=_read_spynet, defaults={"nlevels": 6}))


register(ModelSpec(name="FlowNet2", pad_divisor=64, make=FlowNet2,
                   convert=convert.flownet2_state_from_torch))


def make_model(name: str, **overrides):
    """Construct the module for `name` (weights uninitialized).

    Returns (module, spec)."""
    spec = get_spec(name)
    kwargs = dict(spec.defaults)
    kwargs.update(overrides)
    return spec.make(**kwargs), spec


__all__ = ["ModelSpec", "available_models", "get_spec", "make_model", "register", "FlowNet2",
           "GMA", "PWCDCNet", "RAFT", "RAFTSmall", "SpyNet"]
