"""Flow networks as `nn.Module`s plus the model registry. RAFT, GMA and
PWCNet are ported so far."""

from __future__ import annotations

from pcfa_tpu_torch.models import convert
from pcfa_tpu_torch.models.gma import GMA
from pcfa_tpu_torch.models.pwcnet import PWCDCNet
from pcfa_tpu_torch.models.raft import RAFT
from pcfa_tpu_torch.models.spec import ModelSpec, get_spec, register

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


def make_model(name: str, **overrides):
    """Construct the module for `name` (weights uninitialized).

    Returns (module, spec)."""
    spec = get_spec(name)
    kwargs = dict(spec.defaults)
    kwargs.update(overrides)
    return spec.make(**kwargs), spec


__all__ = ["ModelSpec", "get_spec", "make_model", "register", "GMA",
           "PWCDCNet", "RAFT"]
