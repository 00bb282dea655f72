"""Data-parallel attacks over processes (`pcfa_tpu/parallel/dp.py`), one
device per process.

* `pcfa_attack_dp`: N independent per-pair attacks. The pairs are split
  over the ranks in contiguous blocks (as `multihost.process_shard` splits
  a dataset); each rank runs `attack.pcfa.pcfa_attack` on its block on its
  device, with no collective in the optimization; the results are
  gathered, so every rank returns the same `PCFAResult` with a leading N
  axis.

* `universal_batch_attack_dp`: one δ trained on a batch split over the
  ranks. Every rank holds the same L-BFGS state and its own images. Each
  closure ends, on every rank, with the exact global-batch value and
  δ-gradient, bit-identical across ranks, so the replicated L-BFGS stays
  in step with no other synchronization: the local loss sums and the
  similarity term's δ-gradient are all-reduced in one call; the penalty,
  a function of the replicated δ alone, and its gradient are added once
  (the JAX engine's 1/n_dev share does the same). cosim's sums are taken
  over the global batch inside the objective (`mesh.sum_identity_grad`),
  then only the local images' part of the δ-gradient is all-reduced.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from pcfa_tpu_torch.attack.lbfgs import LBFGSState
from pcfa_tpu_torch.attack.losses import relu_penalty
from pcfa_tpu_torch.attack.pcfa import PCFAConfig, PCFAResult, pcfa_attack
from pcfa_tpu_torch.attack.universal import (
    UniversalConfig,
    UniversalMetrics,
    run_batch,
)
from pcfa_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_cat,
    all_gather_object,
    all_reduce_sum,
    data_mesh,
    sum_identity_grad,
)
from pcfa_tpu_torch.parallel.multihost import process_shard


def _leaves(tree) -> list[torch.Tensor]:
    out = []
    for v in tree:
        out.extend(_leaves(v) if isinstance(v, tuple) else [v])
    return out


def _rebuild(template, leaves):
    """`template`'s nesting of (named) tuples filled from `leaves`."""
    vals = []
    for v in template:
        if isinstance(v, tuple):
            sub, leaves = _rebuild(v, leaves)
            vals.append(sub)
        else:
            vals.append(leaves[0])
            leaves = leaves[1:]
    built = (type(template)(*vals) if hasattr(template, "_fields")
             else type(template)(vals))
    return built, leaves


def gather_pairs(local, mesh: Mesh, device: torch.device | str = "cpu"
                 ) -> tuple[object, list[int]]:
    """Every rank's `local` (a tuple, possibly nested and named, of tensors
    whose leading axis is the rank's pairs; None for a rank without pairs)
    concatenated along that axis in rank order, the same on every rank,
    and the counts per rank. Blocks are padded to the largest for the
    all-gather, so ranks with fewer pairs (or none) take part in every
    gather; such a rank takes the nesting and the shapes from the others
    and holds the result on `device`."""
    if mesh.size == 1:
        return local, [0 if local is None else _leaves(local)[0].shape[0]]
    meta = None
    if local is not None:
        leaves = _leaves(local)
        skeleton = _rebuild(local, [None] * len(leaves))[0]
        meta = (leaves[0].shape[0],
                [(tuple(t.shape[1:]), t.dtype) for t in leaves], skeleton)
    metas = all_gather_object(meta, mesh)
    counts = [0 if m is None else m[0] for m in metas]
    ref = next((m for m in metas if m is not None), None)
    if ref is None:
        return None, counts
    if local is None:
        leaves = [torch.zeros((0, *shape), dtype=dt, device=device)
                  for shape, dt in ref[1]]
    top = max(counts)
    out = []
    for t in leaves:
        pad = t.new_zeros((top - t.shape[0], *t.shape[1:]))
        g = all_gather_cat(torch.cat([t, pad]), mesh)
        out.append(torch.cat([g[r * top:r * top + c]
                              for r, c in enumerate(counts)]))
    return _rebuild(ref[2], out)[0], counts


def make_pcfa_attack_dp(flow_fn: Callable, config: PCFAConfig,
                        mesh: Mesh | None = None,
                        device: str | torch.device = "cuda"):
    """`attack(images1, images2, targets)` over N pairs (every rank passes
    all N): rank r attacks its contiguous block, and every rank returns
    the gathered `PCFAResult` of all N."""
    mesh = mesh or data_mesh()

    def attack(images1, images2, targets) -> PCFAResult:
        block = process_shard(images1.shape[0], mesh.rank, mesh.size)
        local = None
        if block:
            sl = slice(block[0], block[-1] + 1)
            local = pcfa_attack(flow_fn, images1[sl], images2[sl],
                                targets[sl], config, device=device)
        res, _ = gather_pairs(local, mesh, device)
        return res

    return attack


def pcfa_attack_dp(flow_fn: Callable, images1: torch.Tensor,
                   images2: torch.Tensor, targets: torch.Tensor,
                   config: PCFAConfig, mesh: Mesh | None = None,
                   device: str | torch.device = "cuda") -> PCFAResult:
    """Independent PCFA attacks on N pairs, split over the 'data' ranks;
    images (N, H′, W′, 3), targets (N, H, W, 2). Returns a `PCFAResult`
    whose leaves have a leading N axis, the same on every rank. A rank
    left without pairs (N < ranks) attacks nothing and takes part in the
    gather."""
    return make_pcfa_attack_dp(flow_fn, config, mesh, device)(
        images1, images2, targets)


def universal_batch_attack_dp(
        flow_fn: Callable, images1: torch.Tensor, images2: torch.Tensor,
        target: torch.Tensor, opt_state: LBFGSState,
        config: UniversalConfig, mesh: Mesh | None = None
) -> tuple[LBFGSState, UniversalMetrics, torch.Tensor, torch.Tensor]:
    """`attack.universal.universal_batch_attack` on a batch split over the
    'data' ranks: each rank passes its local batch (B_local, H′, W′, 3),
    the same B_local on every rank, and the same `opt_state`. The loss is
    the global batch's (the local batches in rank order,
    `multihost.global_batch`), and so are the metrics. Returns
    (opt_state′, metrics, flow_pred_init, flow_pred), the flows this
    rank's rows of the global batch's."""
    cfg = config
    mesh = mesh or data_mesh()
    if cfg.loss not in ("aee", "mse", "cosim"):
        raise NotImplementedError(
            f"data-parallel universal training: unknown loss {cfg.loss!r}")
    target = target.to(opt_state.x.device)

    def similarity(flow, x):
        """(global similarity value, its δ-gradient through the local
        images alone)."""
        if cfg.loss == "cosim":
            sums = sum_identity_grad(torch.stack([
                torch.sum(flow * target), torch.sum(flow * flow),
                torch.sum(target * target)]), mesh)
            sim = 1.0 - sums[0] / (torch.sqrt(sums[1]) * torch.sqrt(sums[2]))
            (g,) = torch.autograd.grad(sim, x)
            return sim.detach(), all_reduce_sum(g, mesh)
        if cfg.loss == "aee":
            err = torch.sqrt(torch.sum((flow - target) ** 2, dim=-1))
        else:
            err = (flow - target) ** 2
        share = torch.sum(err) / (err.numel() * mesh.size)
        (g,) = torch.autograd.grad(share, x)
        packed = all_reduce_sum(torch.cat([
            share.detach().reshape(1).to(g.dtype), g.reshape(-1)]), mesh)
        return packed[0], packed[1:].reshape(g.shape)

    def value_and_grad(x, perturbed):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            px1, px2, d1, d2 = perturbed(x)
            sim, g_sim = similarity(flow_fn(px1, px2), x)
            pen = cfg.mu * relu_penalty(d1, d2, cfg.delta_bound)
            (g_pen,) = torch.autograd.grad(pen, x)
        value = (sim.to(x.dtype) + pen.detach().to(x.dtype)).reshape(1)
        return value, g_sim.to(x.dtype) + g_pen

    return run_batch(flow_fn, images1, images2, target, opt_state, cfg,
                     value_and_grad, functools.partial(global_mean_epe,
                                                       mesh=mesh))


def global_mean_epe(a: torch.Tensor, b: torch.Tensor,
                    mesh: Mesh) -> torch.Tensor:
    """The mean endpoint error over the global batch of two local
    (B_local, H, W, 2) flows, the same B_local on every rank."""
    s = torch.sum(torch.sqrt(torch.sum((a - b) ** 2, dim=-1)))
    n = a.shape[0] * a.shape[1] * a.shape[2]
    return all_reduce_sum(s, mesh) / (n * mesh.size)
