"""Fold BatchNorm into the preceding conv for inference, port of
``das_tpu/models/fuse.py`` (ref tools/test.py:175-176 ``--fuse-conv-bn`` /
mmcv ``fuse_conv_bn``).

Each eval BatchNorm is folded into the weight and bias of its conv and then
replaced by ``nn.Identity``, as mmcv's ``fuse_conv_bn`` does; the conv
gains a bias where it had none. The pairs are those the JAX function finds
as ``{conv, bn}`` siblings of a ``ConvModule``: here a ``ConvModule``'s
``conv`` and ``bn``, and a ``Bottleneck``'s ``conv1/bn1``, ``conv2/bn2``
and ``conv3/bn3`` (the reference's flat names for what JAX builds as three
``ConvModule``s). GroupNorm modules, deform convs and the fused conv+GN
path are left as they are.

Load the unfused state dict first, then fuse: the fused model has no
``bn`` keys and biases where the reference's convs have none.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from .layers import BatchNorm, ConvModule
from .mspn import Bottleneck


def _fold(conv: nn.Conv2d, bn: BatchNorm) -> None:
    """conv <- bn(conv(.)), in f32, stored in the conv's dtype."""
    with torch.no_grad():
        factor = bn.weight.float() / torch.sqrt(bn.running_var.float()
                                                + 1e-5)          # (Cout,)
        w = conv.weight.float() * factor[:, None, None, None]
        b = torch.zeros_like(factor) if conv.bias is None \
            else conv.bias.float()
        b = (b - bn.running_mean.float()) * factor + bn.bias.float()
        dt = conv.weight.dtype
        conv.weight.copy_(w.to(dt))
        if conv.bias is None:
            conv.bias = nn.Parameter(b.to(dt))
        else:
            conv.bias.copy_(b.to(dt))


def fuse_conv_bn(model: nn.Module) -> Tuple[nn.Module, int]:
    """Fold every eval BatchNorm of ``model`` into its conv, in place.
    Returns ``(model, number of fused pairs)``."""
    n = 0
    for m in list(model.modules()):
        pairs = []
        if isinstance(m, ConvModule) and m.norm_name == 'bn' \
                and isinstance(m.conv, nn.Conv2d):
            pairs = [('conv', 'bn')]
        elif isinstance(m, Bottleneck):
            pairs = [(f'conv{i}', f'bn{i}') for i in (1, 2, 3)]
        for conv_name, bn_name in pairs:
            bn = getattr(m, bn_name)
            if not isinstance(bn, BatchNorm):
                continue                                 # already fused
            if bn.training:
                raise ValueError('fuse_conv_bn folds eval BatchNorms only; '
                                 'call model.eval() first')
            _fold(getattr(m, conv_name), bn)
            setattr(m, bn_name, nn.Identity())
            n += 1
    return model, n
