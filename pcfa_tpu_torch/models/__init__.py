"""Flow networks as `nn.Module`s plus the model registry. RAFT and PWCNet
are ported so far."""

from __future__ import annotations

from pcfa_tpu_torch.models.pwcnet import PWCDCNet
from pcfa_tpu_torch.models.raft import RAFT
from pcfa_tpu_torch.models.spec import ModelSpec, get_spec, register

register(
    ModelSpec(
        name="RAFT",
        pad_divisor=8,
        iters=12,
        make=RAFT,
        defaults={"iters": 12},
    )
)

register(ModelSpec(name="PWCNet", pad_divisor=64, make=PWCDCNet))


def make_model(name: str, **overrides):
    """Construct the module for `name` (weights uninitialized).

    Returns (module, spec)."""
    spec = get_spec(name)
    kwargs = dict(spec.defaults)
    kwargs.update(overrides)
    return spec.make(**kwargs), spec


__all__ = ["ModelSpec", "get_spec", "make_model", "register", "PWCDCNet",
           "RAFT"]
