"""HRNetV2 (Sun et al., CVPR 2019, arXiv:1902.09212; the four-output form
of Wang et al., TPAMI 2020, arXiv:1908.07919), as mmdet's ``HRNet``
builds it from its ``extra``: a stem of two stride-2 3x3 conv+BN+ReLU
layers to 64 channels, stage 1 (``layer1``, Bottlenecks at stride 4),
then stages 2 to 4 of modules with 2, 3 and 4 parallel branches at
strides 4 to 32. A module runs each branch's blocks, then gives each
branch i the ReLU of the sum over branches j of: branch i itself (j = i);
a 1x1 conv+BN then nearest upsampling to branch i's size (j > i); a chain
of i - j stride-2 3x3 conv+BN, ReLU after all but the last (j < i). A
transition before each stage adds a branch by a stride-2 3x3
conv+BN+ReLU of the last one, and adapts a width that changes by a 3x3
conv+BN+ReLU. All four branches come out, lowest stride first.

mmdet upsamples by ``scale_factor=2**(j-i)``; this goes to the branch's
size, the same where the image's sides are multiples of 32, as every
bucket's are. Keys are mmdet's (``conv1``, ``bn1``, ``layer1``,
``transition1``, ``stage2.0.branches``, ``stage2.0.fuse_layers``...),
its ``nn.Sequential(conv, norm[, ReLU])`` with the keys ``0`` and ``1``,
built from ``model``'s ``Conv`` and ``BatchNorm``. With ``remat`` the
stem with stage 1 is one checkpointed region and each module another;
``frozen_stages`` >= 0 freezes the stem, >= 1 stage 1 too, which
``train()`` keeps in eval.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..model import BatchNorm, Conv

# the keys of the backbone section that are the repo configuration's
REPO_KEYS = ('extra', 'frozen_stages')


class ConvBN(nn.Sequential):
    """A bias-free conv (``0``, padding k // 2) and a BatchNorm (``1``),
    then ReLU where ``relu``."""

    def __init__(self, cin, cout, k, stride=1, relu=False):
        super().__init__(Conv(cin, cout, k, stride, k // 2, bias=False),
                         BatchNorm(cout))
        self.relu = relu

    def forward(self, x):
        x = self[1](self[0](x))
        return F.relu(x) if self.relu else x


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, downsample=None):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = downsample

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + idt)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, downsample=None):
        super().__init__()
        self.conv1 = Conv(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + idt)


BLOCKS = {'BASIC': BasicBlock, 'BOTTLENECK': Bottleneck}


def layer(block, cin, planes, blocks):
    out = planes * block.expansion
    down = ConvBN(cin, out, 1) if cin != out else None
    return nn.Sequential(block(cin, planes, down),
                         *[block(out, planes) for _ in range(1, blocks)])


class HRModule(nn.Module):

    def __init__(self, block, num_blocks, channels):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList([
            layer(block, channels[i] * block.expansion, channels[i],
                  num_blocks[i]) for i in range(n)])
        ch = [c * block.expansion for c in channels]

        def path(j, i):
            if j == i:
                return None
            if j > i:
                return ConvBN(ch[j], ch[i], 1)
            return nn.Sequential(*[
                ConvBN(ch[j], ch[i] if k == i - j - 1 else ch[j], 3, 2,
                       relu=k < i - j - 1) for k in range(i - j)])
        self.fuse_layers = None if n == 1 else nn.ModuleList([
            nn.ModuleList([path(j, i) for j in range(n)]) for i in range(n)])

    def forward(self, xs):
        xs = [b(x) for b, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        out = []
        for i, paths in enumerate(self.fuse_layers):
            y = 0
            for j, (p, x) in enumerate(zip(paths, xs)):
                if j == i:
                    y = y + x
                elif j > i:
                    y = y + F.interpolate(p(x), size=xs[i].shape[2:],
                                          mode='nearest')
                else:
                    y = y + p(x)
            out.append(F.relu(y))
        return out


class HRNet(nn.Module):

    def __init__(self, extra, frozen_stages=-1):
        super().__init__()
        self.frozen_stages = frozen_stages
        self.conv1 = Conv(3, 64, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm(64)
        self.conv2 = Conv(64, 64, 3, 2, 1, bias=False)
        self.bn2 = BatchNorm(64)
        s1 = extra['stage1']
        block = BLOCKS[s1['block']]
        self.layer1 = layer(block, 64, s1['num_channels'][0],
                            s1['num_blocks'][0])
        pre = [s1['num_channels'][0] * block.expansion]
        for s in (2, 3, 4):
            cfg = extra[f'stage{s}']
            block = BLOCKS[cfg['block']]
            cur = [c * block.expansion for c in cfg['num_channels']]
            trans = []
            for i, c in enumerate(cur):
                if i < len(pre):
                    trans.append(None if c == pre[i] else
                                 ConvBN(pre[i], c, 3, 1, relu=True))
                else:
                    trans.append(nn.Sequential(*[
                        ConvBN(pre[-1], c if k == i - len(pre) else pre[-1],
                               3, 2, relu=True)
                        for k in range(i + 1 - len(pre))]))
            self.add_module(f'transition{s - 1}', nn.ModuleList(trans))
            self.add_module(f'stage{s}', nn.Sequential(*[
                HRModule(block, cfg['num_blocks'], cfg['num_channels'])
                for _ in range(cfg['num_modules'])]))
            pre = cur

    def frozen(self) -> List[nn.Module]:
        if self.frozen_stages < 0:
            return []
        stem = [self.conv1, self.bn1, self.conv2, self.bn2]
        return stem + ([self.layer1] if self.frozen_stages >= 1 else [])

    def train(self, mode=True):
        super().train(mode)
        for m in self.frozen():
            m.eval()
        return self

    def _stem_stage1(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return self.layer1(x)

    def forward(self, x, remat=False):
        x = checkpoint(self._stem_stage1, x, use_reentrant=False) if remat \
            else self._stem_stage1(x)
        xs = [x]
        for s in (2, 3, 4):
            trans = getattr(self, f'transition{s - 1}')
            xs = [xs[i] if t is None else t(xs[min(i, len(xs) - 1)])
                  for i, t in enumerate(trans)]
            for module in getattr(self, f'stage{s}'):
                xs = checkpoint(module, xs, use_reentrant=False) if remat \
                    else module(xs)
        return xs


def build(b: Dict) -> HRNet:
    return HRNet(b['extra'], b['frozen_stages'])


def out_channels(b: Dict) -> List[int]:
    s4 = b['extra']['stage4']
    expansion = BLOCKS[s4['block']].expansion
    return [c * expansion for c in s4['num_channels']]


def frozen_prefixes(b: Dict) -> Tuple[str, ...]:
    """The parameters ``frozen_stages`` holds still: the stem, and stage 1
    where it is 1 or more."""
    k = b['frozen_stages']
    if k < 0:
        return ()
    stem = ('backbone.conv1.', 'backbone.bn1.', 'backbone.conv2.',
            'backbone.bn2.')
    return stem + (('backbone.layer1.',) if k >= 1 else ())
