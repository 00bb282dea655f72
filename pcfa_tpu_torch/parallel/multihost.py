"""Multi-process runs (`pcfa_tpu/parallel/multihost.py`): join the process
group, the 'data' mesh over every process, each process's dataset slice,
and the global batch.

    torchrun --nproc_per_node=2 -m pcfa_tpu_torch.cli.attack_pcfa ...

or, without torchrun, MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and
LOCAL_RANK in each process's environment (or `initialize`'s arguments).
Each process uses one device: card LOCAL_RANK mod the number of cards.

A process's rank and the world size come from `torch.distributed` when
its process group is initialized, and are 0 and 1 otherwise.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from pcfa_tpu_torch.parallel.mesh import Mesh, data_mesh


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def choose_backend(num_processes: int, local_processes: int | None = None
                   ) -> tuple[str, str]:
    """(backend, why): PCFA_DIST_BACKEND when set, else 'nccl' when every
    process of a host has a card of its own, else 'gloo' (NCCL refuses two
    ranks on one card)."""
    env = os.environ.get("PCFA_DIST_BACKEND")
    if env:
        return env, "PCFA_DIST_BACKEND"
    local = local_processes or num_processes
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards >= local:
        return "nccl", f"{local} processes per host, {cards} cards"
    return "gloo", f"{local} processes per host, {cards} cards"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None,
               timeout_s: float = 600.0) -> None:
    """Join (or form) the process group. A no-op when one is initialized
    already, or when no coordinator is configured (a one-process run).

    The arguments come first, then torchrun's environment: MASTER_ADDR and
    MASTER_PORT (the coordinator, `host:port`), WORLD_SIZE, RANK, and
    LOCAL_RANK (the card: LOCAL_RANK mod the cards present; RANK when it
    is unset). The backend is `backend`, else `choose_backend`'s; the
    choice is printed. A collective that waits longer than `timeout_s`
    raises."""
    if dist.is_initialized():
        return
    if coordinator_address is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if not coordinator_address:
        return
    num = num_processes if num_processes is not None \
        else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if num is None or rank is None:
        raise ValueError(
            "a process group needs its size and this process's rank: pass "
            "num_processes and process_id, or set WORLD_SIZE and RANK")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    if backend is None:
        backend, why = choose_backend(num, _env_int("LOCAL_WORLD_SIZE"))
    else:
        why = "asked for"
    if rank == 0:
        print(f"pcfa_tpu_torch: process group of {num} over "
              f"{coordinator_address}, backend {backend} ({why})",
              flush=True)
    address = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=address, world_size=num, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def process_index_and_count() -> tuple[int, int]:
    """(rank, world size) of this process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_data_mesh() -> Mesh:
    """The 'data' mesh over every process, in rank order."""
    return data_mesh()


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


def global_batch(mesh: Mesh, *local_batches):
    """The global batch's convention, which the 'data' engines
    (`parallel.dp`) follow: each rank holds its own local batch, and the
    global batch is their concatenation in rank order. Nothing moves: the
    local batches come back as they are (one, or a tuple)."""
    del mesh
    return local_batches if len(local_batches) != 1 else local_batches[0]
