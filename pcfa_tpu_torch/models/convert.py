"""Weight bridge from the JAX package's RAFT parameter tree to this
package's `state_dict`.

The tree is a nested dict of numpy arrays (as `pcfa_tpu` builds it from a
checkpoint or from random init). Conv kernels go HWIO → OIHW; folded
BatchNorms stay as scale/bias. Key names follow the reference torch RAFT,
except that a BatchNorm carries `scale`/`bias` instead of its four
running statistics, so loading a reference checkpoint later is this key map
plus the BatchNorm fold.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def conv_weight(kernel) -> np.ndarray:
    """HWIO kernel → OIHW weight."""
    return np.ascontiguousarray(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


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
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}
