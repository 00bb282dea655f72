"""Row sharding of RAFT's and GMA's O(N²) objects over processes
(`pcfa_tpu/parallel/sp.py`): the correlation volume, N = H/8·W/8
positions per side, and GMA's (N, N) attention.

A RAFT or GMA built with `spatial_shards = S` runs on each of the S ranks
of the 'space' mesh (`space_mesh`). Every rank runs both encoders, the GRU
and the upsampler on the whole frame, alike; rank r builds the pyramid of
its own block of H/8 rows of `fmap1` against the whole of `fmap2`
(materialized, or the rows' blocks against the pooled f2 features when
fused), looks up its own rows of `coords1` each iteration, and all-gathers
the corr features of every row before the update block. In GMA it keeps
only its query rows of the attention and all-gathers the aggregate.
Pyramid and attention memory per rank fall S×.

Gradients, with the two operators of tensor-parallel training
(`parallel.mesh`): g (`gather_rows`) is the all-gather, whose backward
keeps the rank's own rows of the cotangent, which every rank holds alike;
f (`reduce_grad`) is the identity, whose backward all-reduces, placed on
`fmap1` and `fmap2`, on GMA's context features entering `to_qk` and on
its values `to_v(motion)`, where they enter the sharded branch. Every
rank computes the same loss and ends `backward()` with the serial model's
input gradient, so the attack engines run unchanged on
`spatial_flow_fn`.
"""

from __future__ import annotations

from typing import Callable

import torch

from pcfa_tpu_torch.parallel.mesh import Mesh, make_mesh


def space_mesh(num_devices: int | None = None) -> Mesh:
    """The 'space' mesh over every process (one device each)."""
    return make_mesh("space", num_devices)


def spatial_flow_fn(model, mesh: Mesh | None = None
                    ) -> Callable[[torch.Tensor, torch.Tensor],
                                  torch.Tensor]:
    """`(x1, x2) → flow_up` of a RAFT or GMA built with `spatial_shards =
    mesh.size`: the full flow on every rank (inputs are the whole frames
    on every rank). Raises when the rows do not split over the ranks."""
    mesh = mesh or space_mesh()
    n_dev = mesh.size
    shards = getattr(model, "spatial_shards", n_dev)

    def flow_fn(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        H = x1.shape[1]
        if H % n_dev:
            raise ValueError(
                f"spatial sharding needs image height divisible by the "
                f"'space' mesh size: H={H}, devices={n_dev}. Pad H to a "
                f"multiple of {n_dev} (on top of the model's pad divisor).")
        if (H // 8) % shards:
            raise ValueError(
                f"RAFT-family spatial sharding slices the H/8 feature rows: "
                f"H/8={H // 8} must be divisible by spatial_shards={shards} "
                f"(H={H}). Pad H to a multiple of {8 * shards}.")
        out = model(x1, x2)
        return out[-1] if isinstance(out, tuple) else out

    return flow_fn
