"""Seeded weights for a configuration, made on the device.

The scheme is the configuration's ``assumed.weights``: LeCun-normal
convolutions and linear layers, the head's convolutions at a fixed
standard deviation (the reference head's init), the RU's DCN He-normal,
unit norms and running statistics, and a few leaves set apart so that a
random model behaves as a deployed one in the places the benchmark
measures: the DCN ``conv_offset`` non-zero (fractional offsets of a few
pixels, where a fresh model's are zero), and the classification,
centerness and joint heads spread so that the decode keeps people. All
normal draws are one ``torch.randn`` call on the device.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Tuple

import torch

from .reference import model as ref_model


def _std(key: str, shape, w: Dict) -> float:
    """The standard deviation of a normally drawn leaf."""
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
    lecun = 1.0 / math.sqrt(fan_in)
    if key.endswith('conv_offset.weight'):
        return w['conv_offset_std']
    if key.startswith('bbox_head.recursive_update_branch.'):
        if key.endswith('update_feat_conv.conv.weight'):
            return math.sqrt(2.0 / fan_in)
        if key.endswith('sampling_offset.weight'):
            return w['sampling_offset_std']
        return lecun
    if key.startswith('bbox_head.flow'):
        return lecun
    if key.startswith('bbox_head.'):
        for prefix, name in (('bbox_head.conv_cls.', 'cls_std'),
                             ('bbox_head.conv_centerness.', 'centerness_std'),
                             ('bbox_head.conv_poses.0.', 'uvd_std')):
            if key.startswith(prefix):
                return w[name]
        return w['head_std']
    return lecun


def _constant(key: str, w: Dict, norm: bool):
    """The value of a leaf that is not drawn, or None for a drawn one;
    ``norm``: the leaf is a norm module's."""
    leaf = key.rsplit('.', 1)[-1]
    if leaf == 'running_mean':
        return 0.0
    if leaf == 'running_var':
        return 1.0
    if leaf == 'scale':
        return 1.0
    if key == 'bbox_head.conv_cls.bias':
        return w['cls_bias']
    if leaf == 'bias':
        return 0.0
    if norm:
        return 1.0
    return None


def leaves(model_cfg: Dict, scheme: Dict) -> List[Tuple]:
    """(key, shape, std, constant) of each leaf of the reference's state,
    in its order: a drawn leaf's standard deviation and None, or None and
    the value of one that is not drawn. A leaf is a norm's where its
    module is the reference's ``BatchNorm`` or ``GroupNorm``."""
    model = ref_model.build(model_cfg, 'meta')
    norms = {name for name, m in model.named_modules()
             if isinstance(m, (ref_model.BatchNorm, ref_model.GroupNorm))}
    out = []
    for k, v in model.state_dict().items():
        s = tuple(v.shape)
        const = _constant(k, scheme, k.rsplit('.', 1)[0] in norms)
        out.append((k, s, _std(k, s, scheme) if const is None else None,
                    const))
    return out


def make_state(model_cfg: Dict, scheme: Dict, seed: int, device
               ) -> Dict[str, torch.Tensor]:
    """The state dict (float32, on ``device``) of the reference's keys for
    ``seed``. Its normal draws come from one generator on the device."""
    table = leaves(model_cfg, scheme)
    drawn = [(k, s, std) for k, s, std, const in table if const is None]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    total = sum(math.prod(s) for _, s, _ in drawn)
    z = torch.randn(total, generator=gen, device=device)
    state, begin = OrderedDict(), 0
    for k, s, std in drawn:
        n = math.prod(s)
        state[k] = z[begin:begin + n].view(s).mul_(std)
        begin += n
    for k, s, _, const in table:
        if const is not None:
            state[k] = torch.full(s, float(const), device=device)
    return OrderedDict((k, state[k]) for k, *_ in table)
