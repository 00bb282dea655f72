"""Weight bridges from the JAX package's parameter trees (RAFT, PWCNet) to
this package's `state_dict`s.

A tree is a nested dict of numpy arrays (as `pcfa_tpu` builds it from a
checkpoint or from random init). Conv kernels go HWIO → OIHW; transposed
conv kernels (flax `ConvTranspose`, taps flipped) go back to torch's
unflipped IOHW; folded BatchNorms stay as scale/bias. Key names follow the
reference torch networks, except that a BatchNorm carries `scale`/`bias`
instead of its four running statistics, so loading a reference checkpoint
later is this key map plus the BatchNorm fold.
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
    return _tensors(out)


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
