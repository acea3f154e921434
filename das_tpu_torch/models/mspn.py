"""MSPN multi-stage pose backbone, port of ``das_tpu/models/mspn.py``.

A ResNet top (stride 4) feeding N hourglass stages; each stage is a
ResNet-50-style downsample tower plus a top-down upsample module with
cross-stage skips. The last stage gives 4 maps (``unit_channels``) at
strides 4/8/16/32, lowest stride first. Module names are the reference's
(mspn_mmpose.py): ``top.top.0``, ``multi_stage_mspn.{s}``,
``downsample.layer{u}.{b}``, ``upsample.up{i}``.

Under training, ``frozen_stages`` K >= 0 keeps the stem and the first K
units of the first stage's downsample tower in eval mode (running-average
norms whose statistics do not move), as the JAX module runs them; the
optimizer masks their updates (``parallel/train_step.mspn_frozen_prefixes``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config.registry import BACKBONES
from ..ops.interp import interpolate_bilinear_ac
from .layers import BatchNorm, ConvModule, conv2d, max_pool_3x3_s2, remat


def _nhwc(fn, x, *args):
    """Apply an NHWC op to an NCHW tensor (views, no copy)."""
    return fn(x.permute(0, 2, 3, 1), *args).permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """ResNet bottleneck, expansion 4 (ref: mspn_mmpose.py:17-157)."""

    def __init__(self, in_channels: int, mid_channels: int, stride: int = 1,
                 has_downsample: bool = False,
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        out_channels = mid_channels * 4
        self.conv1 = nn.Conv2d(in_channels, mid_channels, 1, bias=False)
        self.bn1 = BatchNorm(mid_channels)
        self.conv2 = nn.Conv2d(mid_channels, mid_channels, 3, stride, 1,
                               bias=False)
        self.bn2 = BatchNorm(mid_channels)
        self.conv3 = nn.Conv2d(mid_channels, out_channels, 1, bias=False)
        self.bn3 = BatchNorm(out_channels)
        self.downsample = ConvModule(in_channels, out_channels, 1, stride, 0,
                                     bias=False, norm_cfg=norm_cfg,
                                     act=None) if has_downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(conv2d(self.conv1, x)))
        out = F.relu(self.bn2(conv2d(self.conv2, out)))
        out = self.bn3(conv2d(self.conv3, out))
        return F.relu(out + identity)


class DownsampleModule(nn.Module):
    """ResNet-style downsample tower (ref: mspn_mmpose.py:213-289)."""

    def __init__(self, num_blocks: Sequence[int], num_units: int = 4,
                 has_skip: bool = False, norm_cfg: Optional[dict] = None,
                 in_channels: int = 64):
        super().__init__()
        self.num_units = num_units
        self.has_skip = has_skip
        in_ch = in_channels
        for u in range(num_units):
            mid = in_channels * (2 ** u)
            stride = 1 if u == 0 else 2
            blocks = []
            for b in range(num_blocks[u]):
                b_stride = stride if b == 0 else 1
                has_ds = b == 0 and (b_stride != 1 or in_ch != mid * 4)
                blocks.append(Bottleneck(in_ch, mid, b_stride, has_ds,
                                         norm_cfg))
                in_ch = mid * 4
            self.add_module(f'layer{u + 1}', nn.ModuleList(blocks))

    def forward(self, x, skip1, skip2):
        out = []
        for u in range(self.num_units):
            for block in getattr(self, f'layer{u + 1}'):
                x = block(x)
            if self.has_skip:
                x = x + skip1[u] + skip2[u]
            out.append(x)
        return out[::-1]                                 # lowest res first


class UpsampleUnit(nn.Module):
    """One top-down unit (ref: mspn_mmpose.py:292-404)."""

    def __init__(self, ind: int, num_units: int, in_channels: int,
                 unit_channels: int = 256, gen_skip: bool = False,
                 gen_cross_conv: bool = False,
                 norm_cfg: Optional[dict] = None, out_channels: int = 64):
        super().__init__()
        self.ind = ind
        kw = dict(norm_cfg=norm_cfg, bias='auto')
        self.in_skip = ConvModule(in_channels, unit_channels, 1, 1, 0,
                                  act=None, **kw)
        self.up_conv = ConvModule(unit_channels, unit_channels, 1, 1, 0,
                                  act=None, **kw) if ind > 0 else None
        self.out_skip1 = ConvModule(in_channels, in_channels, 1, 1, 0,
                                    act='relu', **kw) if gen_skip else None
        self.out_skip2 = ConvModule(unit_channels, in_channels, 1, 1, 0,
                                    act='relu', **kw) if gen_skip else None
        self.cross_conv = ConvModule(unit_channels, out_channels, 1, 1, 0,
                                     act='relu', **kw) \
            if ind == num_units - 1 and gen_cross_conv else None

    def forward(self, x, up_x):
        out = self.in_skip(x)
        if self.ind > 0:
            up_x = _nhwc(interpolate_bilinear_ac, up_x, x.shape[2],
                         x.shape[3])
            out = out + self.up_conv(up_x)
        out = F.relu(out)
        skip1 = skip2 = cross_conv = None
        if self.out_skip1 is not None:
            skip1 = self.out_skip1(x)
            skip2 = self.out_skip2(out)
        if self.cross_conv is not None:
            cross_conv = self.cross_conv(out)
        return out, skip1, skip2, cross_conv


class UpsampleModule(nn.Module):
    """Top-down pathway over the reversed downsample outputs
    (ref: mspn_mmpose.py:407-477)."""

    def __init__(self, unit_channels: int = 256, num_units: int = 4,
                 gen_skip: bool = False, gen_cross_conv: bool = False,
                 norm_cfg: Optional[dict] = None, out_channels: int = 64):
        super().__init__()
        self.num_units = num_units
        for i in range(num_units):
            in_ch = out_channels * 4 * 2 ** (num_units - 1 - i)
            self.add_module(f'up{i + 1}', UpsampleUnit(
                i, num_units, in_ch, unit_channels, gen_skip,
                gen_cross_conv, norm_cfg, out_channels))

    def forward(self, x):
        out, skip1, skip2 = [], [], []
        cross_conv = None
        for i in range(self.num_units):
            up_prev = out[i - 1] if i > 0 else None
            o, s1, s2, cc = getattr(self, f'up{i + 1}')(x[i], up_prev)
            out.append(o)
            skip1.append(s1)
            skip2.append(s2)
            if cc is not None:
                cross_conv = cc
        return out, skip1[::-1], skip2[::-1], cross_conv


class SingleStageNetwork(nn.Module):
    """One hourglass stage (ref: mspn_mmpose.py:480-530)."""

    def __init__(self, has_skip=False, gen_skip=False, gen_cross_conv=False,
                 unit_channels=256, num_units=4, num_blocks=(2, 2, 2, 2),
                 norm_cfg=None, in_channels=64):
        super().__init__()
        self.downsample = DownsampleModule(num_blocks, num_units, has_skip,
                                           norm_cfg, in_channels)
        self.upsample = UpsampleModule(unit_channels, num_units, gen_skip,
                                       gen_cross_conv, norm_cfg, in_channels)

    def forward(self, x, skip1, skip2):
        return self.upsample(self.downsample(x, skip1, skip2))


class ResNetTop(nn.Module):
    """Stem: 7x7/2 conv + BN + ReLU + maxpool (ref: mspn_mmpose.py:533-556)."""

    def __init__(self, norm_cfg: Optional[dict] = None, channels: int = 64):
        super().__init__()
        self.top = nn.Sequential(ConvModule(3, channels, 7, 2, 3,
                                            norm_cfg=norm_cfg, act='relu'))

    def forward(self, img):
        return max_pool_3x3_s2(self.top(img))


@BACKBONES.register_module()
class MSPN2(nn.Module):
    """Multi-stage MSPN backbone (ref: mspn_mmpose.py:560-667).

    NCHW image in; 4 maps out at strides 4/8/16/32. ``norm_eval`` is
    recorded and does nothing, as in the JAX module. ``remat`` makes each
    stage one rematerialised region under training (``layers.remat``), as
    JAX wraps each stage in ``nn.remat`` when ``train`` is set: its
    activations are recomputed in the backward, not kept.
    """

    def __init__(self, unit_channels: int = 256, num_stages: int = 4,
                 num_units: int = 4, num_blocks: Sequence[int] = (2, 2, 2, 2),
                 norm_cfg: Optional[dict] = None, res_top_channels: int = 64,
                 frozen_stages: int = -1, norm_eval: bool = False,
                 remat: bool = False):
        super().__init__()
        norm_cfg = norm_cfg or dict(type='BN')
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.remat = remat
        self.top = ResNetTop(norm_cfg, res_top_channels)
        self.multi_stage_mspn = nn.ModuleList([
            SingleStageNetwork(
                has_skip=i != 0, gen_skip=i != num_stages - 1,
                gen_cross_conv=i != num_stages - 1,
                unit_channels=unit_channels, num_units=num_units,
                num_blocks=list(num_blocks), norm_cfg=norm_cfg,
                in_channels=res_top_channels)
            for i in range(num_stages)])

    def frozen_modules(self) -> List[nn.Module]:
        """The stem and layer1..layerK of stage 0 for ``frozen_stages`` K
        (JAX mspn.py:244, :264)."""
        if self.frozen_stages < 0:
            return []
        down = self.multi_stage_mspn[0].downsample
        return [self.top] + [getattr(down, f'layer{u + 1}') for u in range(
            min(self.frozen_stages, down.num_units))]

    def train(self, mode: bool = True):
        super().train(mode)
        for m in self.frozen_modules():
            m.eval()
        return self

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.top(x)
        skip1 = skip2 = None
        out = None
        for stage in self.multi_stage_mspn:
            if self.remat and self.training:
                out, skip1, skip2, x = remat(stage, stage, x, skip1, skip2)
            else:
                out, skip1, skip2, x = stage(x, skip1, skip2)
        return list(out[::-1])                   # strides [4, 8, 16, 32]
