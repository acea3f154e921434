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

``fold_conv_bn_keep_layout`` is the JAX function's own fold, which keeps
every key: each BatchNorm is left as identity statistics with the additive
term in its bias, and its conv's weight is pre-scaled by sqrt(1 + eps) so
that the identity BatchNorm composes exactly. Its state dict is what the
JAX package's ``tools/misc/fuse_conv_bn.py`` writes, and loads strictly
into an unfused model.
"""

from __future__ import annotations

import math
from typing import Iterator, Tuple

import torch
import torch.nn as nn

from .layers import BatchNorm, ConvModule
from .mspn import Bottleneck


_EPS = 1e-5


def _folded(conv: nn.Module, bn: BatchNorm):
    """The fold's per-channel factor gamma / sqrt(var + eps) and folded bias
    (b - mean) * factor + beta, b the conv's bias or 0, both in f32."""
    factor = bn.weight.float() / torch.sqrt(bn.running_var.float() + _EPS)
    b = torch.zeros_like(factor) if conv.bias is None else conv.bias.float()
    return factor, (b - bn.running_mean.float()) * factor + bn.bias.float()


def _fold(conv: nn.Conv2d, bn: BatchNorm) -> None:
    """conv <- bn(conv(.)), in f32, stored in the conv's dtype."""
    with torch.no_grad():
        factor, b = _folded(conv, bn)
        w = conv.weight.float() * factor[:, None, None, None]
        dt = conv.weight.dtype
        conv.weight.copy_(w.to(dt))
        if conv.bias is None:
            conv.bias = nn.Parameter(b.to(dt))
        else:
            conv.bias.copy_(b.to(dt))


def _pairs(model: nn.Module) -> Iterator[Tuple[nn.Module, str, str]]:
    """(module, conv name, bn name) of every conv + eval BatchNorm pair not
    fused yet."""
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
            yield m, conv_name, bn_name


def fuse_conv_bn(model: nn.Module) -> Tuple[nn.Module, int]:
    """Fold every eval BatchNorm of ``model`` into its conv, in place.
    Returns ``(model, number of fused pairs)``."""
    n = 0
    for m, conv_name, bn_name in _pairs(model):
        _fold(getattr(m, conv_name), getattr(m, bn_name))
        setattr(m, bn_name, nn.Identity())
        n += 1
    return model, n


def fold_conv_bn_keep_layout(model: nn.Module) -> Tuple[nn.Module, int]:
    """The JAX package's fold, in place and keeping every module and key
    (``das_tpu/models/fuse.py``): conv <- conv * factor * sqrt(1 + eps);
    the BatchNorm keeps weight 1, running mean 0 and running variance 1,
    and the additive term goes into its bias (into the conv's bias, the
    BatchNorm's then 0, where the conv has one). Returns ``(model, number
    of folded pairs)``."""
    n = 0
    denom = math.sqrt(1.0 + _EPS)
    with torch.no_grad():
        for m, conv_name, bn_name in _pairs(model):
            conv, bn = getattr(m, conv_name), getattr(m, bn_name)
            factor, b = _folded(conv, bn)
            conv.weight.copy_((conv.weight.float()
                               * factor[:, None, None, None] * denom)
                              .to(conv.weight.dtype))
            if conv.bias is not None:
                conv.bias.copy_((b * denom).to(conv.bias.dtype))
                bn.bias.zero_()
            else:
                bn.bias.copy_(b.to(bn.bias.dtype))
            bn.weight.fill_(1.0)
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0)
            n += 1
    return model, n
