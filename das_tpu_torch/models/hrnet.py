"""HRNet backbone (HRNetV2: every branch is an output), as mmdet's
``HRNet`` (mmdet/models/backbones/hrnet.py; Sun et al., CVPR 2019,
arXiv:1902.09212; the four-output form of Wang et al., TPAMI 2020,
arXiv:1908.07919). The JAX package has no HRNet; the plain PyTorch
reference is ``dasbench/reference/backbones/HRNet.py``.

A stem of two stride-2 3x3 conv+BN+ReLU layers to 64 channels, stage 1
(``layer1``: ResNet Bottlenecks at stride 4), then stages 2 to 4 of
``HRModule``s: 2, 3 and 4 parallel branches at strides 4 to 32, each a
stack of blocks, and after every module a fusion that gives each branch
the sum of all branches brought to its resolution, then ReLU (a higher
resolution through a chain of stride-2 3x3 conv+BN, ReLU between them;
a lower one through a 1x1 conv+BN and nearest upsampling). A transition
before each stage adds a branch (a stride-2 3x3 conv+BN+ReLU of the
lowest-resolution map) and adapts widths that change. The four branch
maps are the output, lowest stride first.

Key names are mmdet's (``conv1``, ``bn1``, ``conv2``, ``bn2``,
``layer1``, ``transition{1,2,3}``, ``stage{2,3,4}.{m}.branches``,
``.fuse_layers``): its ``nn.Sequential(conv, norm[, ReLU])`` pairs keep
the keys ``0`` and ``1``, so ``ConvModule``'s ``conv``/``bn`` names are
not used here. A norm has no ``num_batches_tracked``. The fusion's
upsampling goes to the size of the branch it feeds, which is mmdet's
``nn.Upsample(scale_factor=2**(j-i))`` wherever the image's sides are
multiples of 32, as every bucket's are.

Under training, ``frozen_stages`` K >= 0 keeps the stem (K = 0) and then
stage 1 (K >= 1) in eval, and ``frozen_prefixes`` names their parameters
for the optimizer to hold still; ``norm_eval`` keeps every BatchNorm in
eval (mmdet's). With ``remat`` the stem with stage 1 is one
rematerialised region and each ``HRModule`` another (``layers.remat``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config.registry import BACKBONES
from ..ops.interp import upsample_nearest
from ..utils.profiling import span
from .layers import BatchNorm, conv2d, norm_act, remat


class ConvBN(nn.Sequential):
    """mmdet's ``nn.Sequential(conv, norm[, ReLU])``: a bias-free conv
    (key ``0``, padding k // 2) and a BatchNorm (``1``), then ReLU where
    ``relu``; the conv runs in its compute dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 relu: bool = False):
        super().__init__(nn.Conv2d(cin, cout, k, stride, k // 2, bias=False),
                         BatchNorm(cout))
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm_act(self[1], conv2d(self[0], x), relu=self.relu)


class BasicBlock(nn.Module):
    """ResNet basic block, expansion 1 (mmdet resnet.py)."""

    expansion = 1

    def __init__(self, cin: int, planes: int,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = norm_act(self.bn1, conv2d(self.conv1, x), relu=True)
        return norm_act(self.bn2, conv2d(self.conv2, out), identity,
                        relu=True)


class Bottleneck(nn.Module):
    """ResNet bottleneck, expansion 4 (mmdet resnet.py)."""

    expansion = 4

    def __init__(self, cin: int, planes: int,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = norm_act(self.bn1, conv2d(self.conv1, x), relu=True)
        out = norm_act(self.bn2, conv2d(self.conv2, out), relu=True)
        return norm_act(self.bn3, conv2d(self.conv3, out), identity,
                        relu=True)


BLOCKS = {'BASIC': BasicBlock, 'BOTTLENECK': Bottleneck}


def make_layer(block, cin: int, planes: int, blocks: int) -> nn.Sequential:
    """``blocks`` blocks (all at stride 1 in HRNet), the first with a 1x1
    conv+BN downsample where the width changes (mmdet ``_make_layer``)."""
    out = planes * block.expansion
    down = ConvBN(cin, out, 1) if cin != out else None
    return nn.Sequential(block(cin, planes, down), *[
        block(out, planes) for _ in range(1, blocks)])


def _upsample(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Nearest upsampling of NCHW ``x`` to ``like``'s size."""
    return upsample_nearest(x.permute(0, 2, 3, 1), like.shape[2],
                            like.shape[3]).permute(0, 3, 1, 2)


class HRModule(nn.Module):
    """One multi-resolution module (mmdet ``HRModule``, multiscale
    output): each branch's blocks, then the fusion."""

    def __init__(self, block, num_blocks: Sequence[int],
                 in_channels: Sequence[int], num_channels: Sequence[int]):
        super().__init__()
        n = len(num_channels)
        self.branches = nn.ModuleList([
            make_layer(block, in_channels[i], num_channels[i], num_blocks[i])
            for i in range(n)])
        ch = [c * block.expansion for c in num_channels]
        self.fuse_layers = None if n == 1 else nn.ModuleList([
            nn.ModuleList([self._fuse(ch, j, i) for j in range(n)])
            for i in range(n)])

    @staticmethod
    def _fuse(ch: Sequence[int], j: int, i: int) -> Optional[nn.Module]:
        """The path from branch ``j`` to branch ``i``."""
        if j == i:
            return None
        if j > i:
            return ConvBN(ch[j], ch[i], 1)
        return nn.Sequential(*[
            ConvBN(ch[j], ch[i] if k == i - j - 1 else ch[j], 3, 2,
                   relu=k < i - j - 1) for k in range(i - j)])

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        with span('das.hrnet.fuse'):
            out = []
            for i, paths in enumerate(self.fuse_layers):
                y = 0
                for j, (path, x) in enumerate(zip(paths, xs)):
                    if j == i:
                        y = y + x
                    elif j > i:
                        y = y + _upsample(path(x), xs[i])
                    else:
                        y = y + path(x)
                out.append(F.relu(y))
            return out


@BACKBONES.register_module()
class HRNet(nn.Module):
    """HRNet (mmdet's config surface): ``extra`` holds ``stage1`` to
    ``stage4``, each with ``num_modules``, ``num_branches``, ``block``
    ('BASIC' or 'BOTTLENECK'), ``num_blocks`` and ``num_channels``.
    ``norm_cfg`` is BN or SyncBN (one ``BatchNorm``, which takes its
    group from ``parallel.replicate``). NCHW image in; the four branch
    maps out, lowest stride first."""

    def __init__(self, extra: dict, norm_cfg: Optional[dict] = None,
                 frozen_stages: int = -1, norm_eval: bool = False,
                 remat: bool = False):
        super().__init__()
        kind = (norm_cfg or dict(type='BN'))['type']
        if kind not in ('BN', 'SyncBN'):
            raise ValueError(f'HRNet takes a BN or SyncBN norm, not {kind}')
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.remat = remat
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = BatchNorm(64)
        s1 = extra['stage1']
        block = BLOCKS[s1['block']]
        self.layer1 = make_layer(block, 64, s1['num_channels'][0],
                                 s1['num_blocks'][0])
        pre = [s1['num_channels'][0] * block.expansion]
        for s in (2, 3, 4):
            cfg = extra[f'stage{s}']
            block = BLOCKS[cfg['block']]
            cur = [c * block.expansion for c in cfg['num_channels']]
            self.add_module(f'transition{s - 1}', self._transition(pre, cur))
            self.add_module(f'stage{s}', nn.Sequential(*[
                HRModule(block, cfg['num_blocks'], cur, cfg['num_channels'])
                for _ in range(cfg['num_modules'])]))
            pre = cur
        self.out_channels = pre

    @staticmethod
    def _transition(pre: Sequence[int], cur: Sequence[int]) -> nn.ModuleList:
        """mmdet ``_make_transition_layer``: a 3x3 conv+BN+ReLU where an
        existing branch changes width, a chain of stride-2 ones from the
        last branch for each new branch, None elsewhere."""
        out = []
        for i, c in enumerate(cur):
            if i < len(pre):
                out.append(ConvBN(pre[i], c, 3, 1, relu=True)
                           if c != pre[i] else None)
            else:
                out.append(nn.Sequential(*[
                    ConvBN(pre[-1], c if k == i - len(pre) else pre[-1], 3,
                           2, relu=True)
                    for k in range(i + 1 - len(pre))]))
        return nn.ModuleList(out)

    def frozen_modules(self) -> List[nn.Module]:
        """The stem for ``frozen_stages`` K >= 0, and stage 1 for K >= 1."""
        if self.frozen_stages < 0:
            return []
        stem = [self.conv1, self.bn1, self.conv2, self.bn2]
        return stem + ([self.layer1] if self.frozen_stages >= 1 else [])

    def frozen_prefixes(self, prefix: str = 'backbone.') -> Tuple[str, ...]:
        """The parameter prefixes the optimizer holds still, under the
        backbone's own ``prefix`` in the model."""
        if self.frozen_stages < 0:
            return ()
        names = ['conv1.', 'bn1.', 'conv2.', 'bn2.']
        if self.frozen_stages >= 1:
            names.append('layer1.')
        return tuple(prefix + n for n in names)

    def train(self, mode: bool = True):
        super().train(mode)
        for m in self.frozen_modules():
            m.eval()
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, BatchNorm):
                    m.eval()
        return self

    def _stem_stage1(self, x: torch.Tensor) -> torch.Tensor:
        with span('das.hrnet.stem'):
            x = norm_act(self.bn1, conv2d(self.conv1, x), relu=True)
            x = norm_act(self.bn2, conv2d(self.conv2, x), relu=True)
        with span('das.hrnet.stage1'):
            return self.layer1(x)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        regions = self.remat and self.training
        # the stem's region marks every BatchNorm of the backbone while it
        # recomputes: its own are not one module's
        x = remat(self, self._stem_stage1, x) if regions \
            else self._stem_stage1(x)
        xs = [x]
        for s in (2, 3, 4):
            with span(f'das.hrnet.stage{s}'):
                trans = getattr(self, f'transition{s - 1}')
                # a new branch comes from the lowest-resolution one
                xs = [xs[i] if t is None else t(xs[min(i, len(xs) - 1)])
                      for i, t in enumerate(trans)]
                for module in getattr(self, f'stage{s}'):
                    xs = remat(module, module, xs) if regions \
                        else module(xs)
        return xs
