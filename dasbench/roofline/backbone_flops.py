"""A backbone's FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over
the plain reference's backbone of the configuration's type
(``reference.backbones``) on the meta device, one eval forward of a
batch at the cell's (padded) bucket. Convolutions and matrix products are
counted; norms, activations, sums and upsampling are not.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import backbones


@functools.lru_cache(maxsize=8)
def _count(backbone_json: str, batch: int, h: int, w: int) -> int:
    b = json.loads(backbone_json)
    with torch.device('meta'):
        net = backbones.find(b).build(b).eval()
    x = torch.zeros(batch, 3, h, w, device='meta')
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(x)
    return int(counter.get_total_flops())


def flops(backbone: dict, batch: int, hw) -> int:
    return _count(json.dumps(backbone, sort_keys=True), int(batch),
                  int(hw[0]), int(hw[1]))
