"""MSPN2 (mmpose's multi-stage pose network, as the DAS recipe configures
it): a ResNet top, then ``num_stages`` stages of a Bottleneck downsample
tower and an upsample path, each stage handing its skips and cross
features to the next. Its four maps come out at strides 4 to 32, all of
``unit_channels``. With ``remat`` each stage is one checkpointed region;
``frozen_stages`` >= 0 freezes the top and the first stage's first
``frozen_stages`` layers, which ``train()`` keeps in eval.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..model import BatchNorm, Conv, ConvModule

# the keys of the backbone section that are the repo configuration's
REPO_KEYS = ('unit_channels', 'num_stages', 'num_units', 'num_blocks',
             'frozen_stages')


class Bottleneck(nn.Module):

    def __init__(self, cin, mid, stride, downsample):
        super().__init__()
        self.conv1 = Conv(cin, mid, 1, bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv2 = Conv(mid, mid, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(mid)
        self.conv3 = Conv(mid, mid * 4, 1, bias=False)
        self.bn3 = BatchNorm(mid * 4)
        self.downsample = ConvModule(cin, mid * 4, 1, stride, 0,
                                     relu=False) if downsample else None

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + idt)


class Downsample(nn.Module):

    def __init__(self, blocks, units, has_skip, cin):
        super().__init__()
        self.units, self.has_skip = units, has_skip
        ch = cin
        for u in range(units):
            mid = cin * 2 ** u
            layer = []
            for b in range(blocks[u]):
                stride = (1 if u == 0 else 2) if b == 0 else 1
                layer.append(Bottleneck(ch, mid, stride, b == 0 and (
                    stride != 1 or ch != mid * 4)))
                ch = mid * 4
            self.add_module(f'layer{u + 1}', nn.ModuleList(layer))

    def forward(self, x, skip1, skip2):
        out = []
        for u in range(self.units):
            for block in getattr(self, f'layer{u + 1}'):
                x = block(x)
            if self.has_skip:
                x = x + skip1[u] + skip2[u]
            out.append(x)
        return out[::-1]


def resize_align_corners(x, h, w):
    """Bilinear resize with align_corners=True, NCHW."""
    return F.interpolate(x, size=(h, w), mode='bilinear',
                         align_corners=True)


class UpsampleUnit(nn.Module):

    def __init__(self, ind, units, cin, unit_ch, gen_skip, gen_cross, out_ch):
        super().__init__()
        self.ind = ind
        self.in_skip = ConvModule(cin, unit_ch, 1, relu=False)
        self.up_conv = ConvModule(unit_ch, unit_ch, 1, relu=False) \
            if ind > 0 else None
        self.out_skip1 = ConvModule(cin, cin, 1) if gen_skip else None
        self.out_skip2 = ConvModule(unit_ch, cin, 1) if gen_skip else None
        self.cross_conv = ConvModule(unit_ch, out_ch, 1) \
            if ind == units - 1 and gen_cross else None

    def forward(self, x, up_x):
        out = self.in_skip(x)
        if self.ind > 0:
            out = out + self.up_conv(resize_align_corners(
                up_x, x.shape[2], x.shape[3]))
        out = F.relu(out)
        s1 = s2 = cc = None
        if self.out_skip1 is not None:
            s1, s2 = self.out_skip1(x), self.out_skip2(out)
        if self.cross_conv is not None:
            cc = self.cross_conv(out)
        return out, s1, s2, cc


class Upsample(nn.Module):

    def __init__(self, unit_ch, units, gen_skip, gen_cross, out_ch):
        super().__init__()
        self.units = units
        for i in range(units):
            self.add_module(f'up{i + 1}', UpsampleUnit(
                i, units, out_ch * 4 * 2 ** (units - 1 - i), unit_ch,
                gen_skip, gen_cross, out_ch))

    def forward(self, x):
        out, s1, s2, cc = [], [], [], None
        for i in range(self.units):
            o, a, b, c = getattr(self, f'up{i + 1}')(
                x[i], out[-1] if out else None)
            out.append(o)
            s1.append(a)
            s2.append(b)
            cc = c if c is not None else cc
        return out, s1[::-1], s2[::-1], cc


class Stage(nn.Module):

    def __init__(self, first, last, unit_ch, units, blocks, cin):
        super().__init__()
        self.downsample = Downsample(blocks, units, not first, cin)
        self.upsample = Upsample(unit_ch, units, not last, not last, cin)

    def forward(self, x, skip1, skip2):
        return self.upsample(self.downsample(x, skip1, skip2))


class ResNetTop(nn.Module):

    def __init__(self, ch):
        super().__init__()
        self.top = nn.Sequential(ConvModule(3, ch, 7, 2, 3))

    def forward(self, x):
        return F.max_pool2d(self.top(x), 3, 2, 1)


class MSPN2(nn.Module):

    def __init__(self, unit_channels, num_stages, num_units, num_blocks,
                 res_top_channels=64, frozen_stages=-1):
        super().__init__()
        self.frozen_stages = frozen_stages
        self.top = ResNetTop(res_top_channels)
        self.multi_stage_mspn = nn.ModuleList([
            Stage(i == 0, i == num_stages - 1, unit_channels, num_units,
                  num_blocks, res_top_channels) for i in range(num_stages)])

    def frozen(self) -> List[nn.Module]:
        if self.frozen_stages < 0:
            return []
        down = self.multi_stage_mspn[0].downsample
        return [self.top] + [getattr(down, f'layer{u + 1}')
                             for u in range(self.frozen_stages)]

    def train(self, mode=True):
        super().train(mode)
        for m in self.frozen():
            m.eval()
        return self

    def forward(self, x, remat=False):
        x = self.top(x)
        s1 = s2 = None
        for stage in self.multi_stage_mspn:
            if remat:
                out, s1, s2, x = checkpoint(stage, x, s1, s2,
                                            use_reentrant=False)
            else:
                out, s1, s2, x = stage(x, s1, s2)
        return out[::-1]


def build(b: Dict) -> MSPN2:
    return MSPN2(b['unit_channels'], b['num_stages'], b['num_units'],
                 b['num_blocks'], b['res_top_channels'], b['frozen_stages'])


def out_channels(b: Dict) -> List[int]:
    return [b['unit_channels']] * b['num_units']


def frozen_prefixes(b: Dict) -> Tuple[str, ...]:
    """The parameters ``frozen_stages`` holds still: the top, and the
    first stage's downsample layers 1 to ``frozen_stages``."""
    k = b['frozen_stages']
    if k < 0:
        return ()
    return ('backbone.top.',) + tuple(
        f'backbone.multi_stage_mspn.0.downsample.layer{i}.'
        for i in range(1, k + 1))
