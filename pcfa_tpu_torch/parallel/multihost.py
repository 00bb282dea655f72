"""Multi-process helpers (`pcfa_tpu/parallel/multihost.py`).

A process's rank and the world size come from `torch.distributed` when
its process group is initialized, and are 0 and 1 otherwise.
"""

from __future__ import annotations

import torch.distributed as dist


def process_index_and_count() -> tuple[int, int]:
    """(rank, world size) of this process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_shard(n: int,
                  process_index: int | None = None,
                  process_count: int | None = None) -> list[int]:
    """This process's dataset indices: a contiguous, balanced split of
    range(n); the first n mod count processes take one more."""
    rank, world = process_index_and_count()
    p = rank if process_index is None else process_index
    c = world if process_count is None else process_count
    base, extra = divmod(n, c)
    start = p * base + min(p, extra)
    return list(range(start, start + base + (1 if p < extra else 0)))
