"""Weights for this package's `state_dict`s: bridges from the JAX
package's parameter trees (RAFT, GMA, PWCNet), and the reader of the
reference torch checkpoints.

A tree is a nested dict of numpy arrays (as `pcfa_tpu` builds it from a
checkpoint or from random init). Conv kernels go HWIO → OIHW; transposed
conv kernels (flax `ConvTranspose`, taps flipped) go back to torch's
unflipped IOHW; folded BatchNorms stay as scale/bias. Key names follow the
reference torch networks, except that a BatchNorm carries `scale`/`bias`
instead of its four running statistics, so reading a reference checkpoint
(`load_torch_state`, then a network's `*_state_from_torch`) is a key map
plus the BatchNorm fold.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def conv_weight(kernel) -> np.ndarray:
    """HWIO kernel → OIHW weight."""
    return np.ascontiguousarray(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def conv_transpose_weight(kernel) -> np.ndarray:
    """Flipped HWIO `nn.ConvTranspose` kernel → IOHW `ConvTranspose2d`
    weight (the inverse of `pcfa_tpu`'s `conv_transpose_kernel`)."""
    k = np.asarray(kernel)[::-1, ::-1]
    return np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1)))


def _conv(out: dict, key: str, leaf: Mapping) -> None:
    out[f"{key}.weight"] = conv_weight(leaf["kernel"])
    if "bias" in leaf:
        out[f"{key}.bias"] = np.asarray(leaf["bias"])


def _norm(out: dict, key: str, leaf: Mapping) -> None:
    out[f"{key}.scale"] = np.asarray(leaf["scale"])
    out[f"{key}.bias"] = np.asarray(leaf["bias"])


def _encoder(out: dict, prefix: str, tree: Mapping) -> None:
    _conv(out, f"{prefix}.conv1", tree["conv1"])
    _conv(out, f"{prefix}.conv2", tree["conv2"])
    if "norm1" in tree:
        _norm(out, f"{prefix}.norm1", tree["norm1"])
    for i in (1, 2, 3):
        for j in (0, 1):
            blk, t = tree[f"layer{i}_{j}"], f"{prefix}.layer{i}.{j}"
            _conv(out, f"{t}.conv1", blk["conv1"])
            _conv(out, f"{t}.conv2", blk["conv2"])
            for n in ("norm1", "norm2"):
                if n in blk:
                    _norm(out, f"{t}.{n}", blk[n])
            if "downsample" in blk:
                _conv(out, f"{t}.downsample.0", blk["downsample"])
                if "norm3" in blk:
                    _norm(out, f"{t}.downsample.1", blk["norm3"])


def raft_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """`pcfa_tpu` RAFT params {fnet, cnet, update_block} → `state_dict`."""
    out: dict = {}
    _raft(out, tree)
    return _tensors(out)


def gma_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """`pcfa_tpu` GMA params → `state_dict`: RAFT's keys plus
    `update_block.aggregator.{to_v.weight, gamma}` (and `project.weight`
    when it has one), `att.to_qk.weight`, and in the positional variants
    `att.pos_emb.rel_{height,width}.weight`."""
    out: dict = {}
    _raft(out, tree)
    agg = tree["update_block"]["aggregator"]
    _conv(out, "update_block.aggregator.to_v", agg["to_v"])
    if "project" in agg:
        _conv(out, "update_block.aggregator.project", agg["project"])
    out["update_block.aggregator.gamma"] = np.asarray(agg["gamma"])
    att = tree["att"]
    _conv(out, "att.to_qk", att["to_qk"])
    for k, table in att.get("pos_emb", {}).items():
        out[f"att.pos_emb.{k}.weight"] = np.asarray(table)
    return _tensors(out)


def _raft(out: dict, tree: Mapping) -> None:
    _encoder(out, "fnet", tree["fnet"])
    _encoder(out, "cnet", tree["cnet"])
    ub = tree["update_block"]
    for k in ("convc1", "convc2", "convf1", "convf2", "conv"):
        _conv(out, f"update_block.encoder.{k}", ub["encoder"][k])
    for k in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        _conv(out, f"update_block.gru.{k}", ub["gru"][k])
    for k in ("conv1", "conv2"):
        _conv(out, f"update_block.flow_head.{k}", ub["flow_head"][k])
    _conv(out, "update_block.mask.0", ub["mask_conv1"])
    _conv(out, "update_block.mask.2", ub["mask_conv2"])


def pwcnet_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """`pcfa_tpu` PWCDCNet params → `state_dict`. Key families as the
    reference: `conv1a.0.*` (conv + LeakyReLU), `deconv6.*` / `upfeat6.*`
    (IOHW transposed convs), `predict_flow6.*` and `dc_conv7.*` (bare
    convs). The JAX tree has no `deconv2` (unused in the reference)."""
    out: dict = {}
    for name, leaf in tree.items():
        if "0" in leaf:
            _conv(out, f"{name}.0", leaf["0"])
        elif name.startswith(("deconv", "upfeat")):
            out[f"{name}.weight"] = conv_transpose_weight(leaf["kernel"])
            out[f"{name}.bias"] = np.asarray(leaf["bias"])
        else:
            _conv(out, name, leaf)
    return _tensors(out)


def _tensors(arrays: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in arrays.items()}


def load_torch_state(path: str) -> dict[str, torch.Tensor]:
    """A reference checkpoint as a flat state dict (tensors only,
    `weights_only`): a `{'state_dict': …}` wrapper (PWCNet, FlowNet2) is
    unwrapped and the `module.` prefix of a DataParallel state (RAFT, GMA)
    stripped."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, Mapping) and "state_dict" in state:
        state = state["state_dict"]
    return {k.removeprefix("module."): v for k, v in state.items()}


def state_from_torch(sd: Mapping[str, torch.Tensor], module=None,
                     drop: tuple[str, ...] = ()) -> dict[str, torch.Tensor]:
    """A reference state dict in this package's layout: every BatchNorm
    (the stems with running statistics: RAFT's and GMA's `cnet`) folded
    into `scale`/`bias` in eval mode (eps 1e-5), keys under the prefixes in
    `drop` left out. Other keys pass as they are; their names already
    follow the reference."""
    bns = {k.removesuffix(".running_mean") for k in sd
           if k.endswith(".running_mean")}
    out = {}
    for k, v in sd.items():
        stem = k.rpartition(".")[0]
        if not k.startswith(drop) and stem not in bns:
            out[k] = v
    for stem in bns:
        scale = sd[f"{stem}.weight"] / torch.sqrt(
            sd[f"{stem}.running_var"] + 1e-5)
        out[f"{stem}.scale"] = scale
        out[f"{stem}.bias"] = (sd[f"{stem}.bias"]
                               - sd[f"{stem}.running_mean"] * scale)
    return out


def gma_state_from_torch(sd: Mapping[str, torch.Tensor],
                         module) -> dict[str, torch.Tensor]:
    """GMA: the relative-position tables (`att.pos_emb.*`, in every shipped
    file) are kept only for a model with a positional attention variant."""
    positional = hasattr(module.att, "pos_emb")
    return state_from_torch(sd, drop=() if positional else ("att.pos_emb.",))


def pwcnet_state_from_torch(sd: Mapping[str, torch.Tensor],
                            module=None) -> dict[str, torch.Tensor]:
    """PWCNet: the reference builds a `deconv2` that its forward never
    uses; it is left out."""
    return state_from_torch(sd, drop=("deconv2.",))
