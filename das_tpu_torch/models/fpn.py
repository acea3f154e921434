"""FPN neck, port of ``das_tpu/models/fpn.py``.

The DAS configuration of mmdet's FPN: 4 inputs, 4 outputs, lateral 1x1
convs, nearest top-down summation and 3x3 output convs, with norm and no
activation. Its BN/SyncBN norms train as ``layers.BatchNorm`` does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from ..config.registry import NECKS
from ..ops.interp import upsample_nearest
from .layers import ConvModule


@NECKS.register_module()
class FPN(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (256, 256, 256, 256),
                 out_channels: int = 256, num_outs: int = 4,
                 start_level: int = 0, norm_cfg: Optional[dict] = None):
        super().__init__()
        self.start_level = start_level
        used = len(in_channels) - start_level
        assert num_outs == used, \
            'extra FPN levels are outside the DAS config surface'
        kw = dict(norm_cfg=norm_cfg, bias='auto', act=None)
        self.lateral_convs = nn.ModuleList([
            ConvModule(in_channels[i + start_level], out_channels, 1, 1, 0,
                       **kw) for i in range(used)])
        self.fpn_convs = nn.ModuleList([
            ConvModule(out_channels, out_channels, 3, 1, 1, **kw)
            for _ in range(used)])

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [conv(inputs[i + self.start_level])
                    for i, conv in enumerate(self.lateral_convs)]
        for i in range(len(laterals) - 1, 0, -1):
            h, w = laterals[i - 1].shape[2:]
            up = upsample_nearest(laterals[i].permute(0, 2, 3, 1), h, w)
            laterals[i - 1] = laterals[i - 1] + up.permute(0, 3, 1, 2)
        return [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
