"""Process groups and their collectives (`pcfa_tpu/parallel/mesh.py`).

A `Mesh` names the processes of the default `torch.distributed` group
along one axis ('data' for pairs or batches, 'space' for row shards) and
says what this process is in it: its rank, the group's size, its device
and the backend. Without an initialized process group it is a group of
one, and every collective here returns its input.

The collectives take CPU tensors under gloo, CUDA tensors under NCCL, and
CUDA tensors under gloo too, whose `all_reduce` and `all_gather` take
them (two ranks on one card run so). Nothing here catches a failed
collective: it raises in the rank where it failed.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis of the processes of the default group: `rank` of `size`,
    this rank's `device` and the group's `backend` (None for a group of
    one)."""

    axis: str
    rank: int
    size: int
    device: torch.device
    backend: str | None = None

    def rows(self, n: int) -> tuple[int, int]:
        """[start, stop) of this rank's block when `n` rows split evenly."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} "
                             f"'{self.axis}' ranks")
        step = n // self.size
        return self.rank * step, (self.rank + 1) * step


def local_device() -> torch.device:
    """This process's card (`torch.cuda.current_device()`, which
    `multihost.initialize` sets from LOCAL_RANK), or the CPU without one."""
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(axis: str, num_devices: int | None = None) -> Mesh:
    """The mesh of every process of the default group along `axis`; a
    group of one when no process group is initialized. `num_devices`, when
    given, must be the group's size: the port runs one device per
    process."""
    if dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    else:
        rank, size, backend = 0, 1, None
    if num_devices is not None and num_devices != size:
        raise ValueError(
            f"a '{axis}' mesh of {num_devices} devices needs {num_devices} "
            f"processes, one device each; this group has {size}")
    return Mesh(axis, rank, size, local_device(), backend)


def data_mesh(num_devices: int | None = None) -> Mesh:
    """The 'data' mesh: pairs or batch rows split over the processes."""
    return make_mesh("data", num_devices)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Σ over the mesh of `t` (a new tensor; `t` itself when alone)."""
    if mesh.size == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def all_reduce_min(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise minimum over the mesh of `t`."""
    if mesh.size == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MIN)
    return out


def all_gather_cat(t: torch.Tensor, mesh: Mesh, dim: int = 0
                   ) -> torch.Tensor:
    """Every rank's `t` (the same shape on each) concatenated along `dim`
    in rank order."""
    if mesh.size == 1:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t)
    return torch.cat(parts, dim=dim)


def all_gather_object(obj, mesh: Mesh) -> list:
    """Every rank's picklable `obj`, in rank order."""
    if mesh.size == 1:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


class _SumIdentityGrad(torch.autograd.Function):
    """Σ over the mesh forward; the identity backward, for a value that
    every rank then uses alike (its cotangent is the same on each)."""

    @staticmethod
    def forward(ctx, t, mesh):
        return all_reduce_sum(t, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    """g: all-gather along `dim` forward; the backward keeps this rank's
    block of the cotangent, which every rank holds alike (no sum: a sum
    would count it `size` times)."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, t.shape[dim]
        return all_gather_cat(t, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mesh.rank * ctx.n, ctx.n), None, None


class _ReduceGrad(torch.autograd.Function):
    """f: the identity forward; the backward sums the cotangent over the
    mesh, so each rank's partial gradient through its own block becomes
    the whole gradient on every rank."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.mesh), None


def sum_identity_grad(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return t if mesh.size == 1 else _SumIdentityGrad.apply(t, mesh)


def gather_rows(t: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    return t if mesh.size == 1 else _GatherRows.apply(t, mesh, dim)


def reduce_grad(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return t if mesh.size == 1 else _ReduceGrad.apply(t, mesh)
