"""The model's FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over
the plain reference on the meta device, at a cell's shapes. Serving
counts one forward; training counts the forward and the backward that a
step needs, without remat's recompute. Convolutions and matrix products
are counted (the DCN's nine tap products among them); elementwise work
is not.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import model as ref_model


@functools.lru_cache(maxsize=8)
def _count(model_json: str, batch: int, h: int, w: int, train: bool) -> int:
    cfg = json.loads(model_json)
    model = ref_model.build(cfg, 'meta')
    img = torch.zeros(batch, h, w, 3, device='meta')
    with FlopCounterMode(display=False) as counter:
        if train:
            levels = model.train()(img)
            sum(v.sum() for f in levels for v in f.values()).backward()
        else:
            with torch.no_grad():
                model.eval()(img)
    return int(counter.get_total_flops())


def flops(model: dict, batch: int, hw, train: bool) -> int:
    return _count(json.dumps(model, sort_keys=True), batch, int(hw[0]),
                  int(hw[1]), bool(train))
