"""Model FLOPs of one pair, counted on the reference network at a cell's
shapes: `torch.utils.flop_counter.FlopCounterMode` over a forward, and
over a forward with the backward to the two input images only (the
network is frozen), on the meta device, so nothing is computed. The count
is that of the model's products and convolutions, whatever implements
them; recomputation (remat) is not counted."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import attack


def per_pair(make_reference, padded_hw, unpadded_hw, pad) -> dict[str, int]:
    """{'forward': FLOPs, 'closure': FLOPs} of one pair. `pad` is the
    reference's (left, right, top, bottom) amounts."""
    with torch.device("meta"):
        net = make_reference().eval().requires_grad_(False)
        x1 = torch.empty(1, *padded_hw, 3).requires_grad_(True)
        x2 = torch.empty(1, *padded_hw, 3).requires_grad_(True)
        target = torch.zeros(1, *unpadded_hw, 2)
    h, w = padded_hw
    left, right, top, bottom = pad

    def flow(a, b):
        return net(a, b)[:, top:h - bottom, left:w - right]

    with FlopCounterMode(display=False) as fwd:
        with torch.no_grad():
            flow(x1, x2)
    with FlopCounterMode(display=False) as closure:
        loss = attack.avg_epe(flow(x1, x2), target)
        loss.backward()
    return {"forward": fwd.get_total_flops(),
            "closure": closure.get_total_flops()}
