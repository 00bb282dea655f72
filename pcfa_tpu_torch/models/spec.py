"""Model registry (`pcfa_tpu/models/spec.py`): per-network contracts.

Every model takes unit-range (B, H, W, 3) image pairs with H and W
divisible by `pad_divisor` and returns flow at input resolution
(recurrent nets return (flow_lr, flow_up))."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    #: pad H, W to a multiple of this before calling
    pad_divisor: int
    #: recurrent nets: number of refinement iterations
    iters: int | None = None
    #: constructor returning the `nn.Module` (kwargs override defaults)
    make: Callable[..., Any] | None = None
    #: (reference torch state_dict, module) → the module's `state_dict`
    convert: Callable[..., Any] | None = None
    #: (checkpoint path, module) → the module's `state_dict`, for a
    #: checkpoint that is not one torch file (SpyNet's weight directory);
    #: None: `convert(load_torch_state(path), module)`
    read: Callable[..., Any] | None = None
    #: the forward's output, or its last output, is the flow, and the
    #: forward and its backward run fixed shapes with no host
    #: synchronisation and no recomputation, so CUDA graphs can capture
    #: and replay them (`runtime.make_flow_fn` does, on the card:
    #: `utils/graphs.py`); a module whose `graph_capturable(shape1,
    #: shape2, dtype)` refuses an input signature runs it eagerly
    capturable: bool = False
    defaults: dict = dataclasses.field(default_factory=dict)


_REGISTRY: dict[str, ModelSpec] = {}


def register(spec: ModelSpec) -> ModelSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_spec(name: str) -> ModelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown flow network '{name}'. Ported so far: "
            f"{sorted(_REGISTRY)}") from None


def available_models() -> list[str]:
    """The registered networks' names, sorted."""
    return sorted(_REGISTRY)
