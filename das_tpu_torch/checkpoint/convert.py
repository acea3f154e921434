"""Carry weights into the port: from the JAX package's variable tree, or from
a reference ``.pth``.

``state_dict_from_flax`` is the port's own copy of the key and layout
mapping of ``das_tpu.checkpoint.torch_bridge.export_torch_state_dict``:
flax auto-names ``<attr>_<i>`` become ``<attr>.<i>``, kernels go HWIO ->
OIHW (conv) and IO -> OI (dense), norm ``scale`` -> ``weight``, batch-stat
``mean``/``var`` -> ``running_mean``/``running_var``, plus the structural
renames of the MSPN stages, the stem, the bottleneck norms, the
recursive-update layers and the RealNVP sequential indices. The result
loads into the port's model with ``strict=True``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _torch_key(path) -> str:
    name = '.'.join(path)
    # flax auto-names: '<attr>_<i>' -> '<attr>.<i>', to fixpoint so nested
    # list indices ('conv_reg_prevs_0_0') all convert
    prev = None
    while prev != name:
        prev = name
        name = re.sub(r'_(\d+)(?=[._]|$)', r'.\1', name, count=1)
    name = re.sub(r'^backbone\.stage(\d+)\.',
                  r'backbone.multi_stage_mspn.\1.', name)
    name = name.replace('.top.top_conv.', '.top.top.0.')
    name = re.sub(r'recursive_update_branch\.layer\.(\d+)\.',
                  r'recursive_update_branch.layer_\1.', name)
    # bottleneck convK.conv/bn -> convK/bnK (not the ConvModule convs)
    name = re.sub(r'\.conv([123])\.bn\.', r'.bn\1.', name)
    name = re.sub(r'\.conv([123])\.conv\.', r'.conv\1.', name)
    # flow sequential indices j -> 2j (Linear, LeakyReLU, Linear, ...)
    m = re.match(r'^(bbox_head\.flow(?:3d|2d)(?:_update)?)'
                 r'\.([st])\.(\d+)\.(\d+)\.(.*)$', name)
    if m:
        base, st, i, j, rest = m.groups()
        name = f'{base}.{st}.{i}.{int(j) * 2}.{rest}'
    return name


def state_dict_from_flax(params: Dict[str, Any],
                         batch_stats: Dict[str, Any] = None
                         ) -> Dict[str, torch.Tensor]:
    """The JAX tree (nested dicts of numpy arrays) -> the port's
    ``state_dict`` (CPU tensors, the reference's keys and layouts)."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params).items():
        name = _torch_key(path)
        arr = np.asarray(leaf)
        if path[-1] == 'kernel':
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)       # HWIO -> OIHW
            elif arr.ndim == 2:
                arr = arr.transpose(1, 0)             # IO -> OI
            name = name[:-len('kernel')] + 'weight'
        elif path[-1] == 'scale' and arr.ndim == 1:
            name = name[:-len('scale')] + 'weight'    # norm gamma
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)) \
            .reshape(arr.shape)
    for path, leaf in _flatten(batch_stats or {}).items():
        name = _torch_key(path)
        if path[-1] == 'mean':
            name = name[:-len('mean')] + 'running_mean'
        elif path[-1] == 'var':
            name = name[:-len('var')] + 'running_var'
        out[name] = torch.from_numpy(np.ascontiguousarray(np.asarray(leaf)))
    return out


def strip_prefixes(sd: Dict[str, Any]) -> Dict[str, Any]:
    """mmcv get_state_dict prefix stripping (ref mspn_mmpose.py:161-193)."""
    out = {}
    for k, v in sd.items():
        if k.startswith('module.backbone.'):
            out[k[len('module.backbone.'):]] = v
        elif k.startswith('module.'):
            out[k[len('module.'):]] = v
        else:
            out[k] = v
    return out


def _read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth``'s state dict with mmcv's prefixes stripped, less the
    constants the model does not keep as state (``num_batches_tracked``,
    the RealNVP ``mask`` buffers), which the JAX bridge drops too."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    sd = ckpt.get('state_dict', ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v for k, v in strip_prefixes(sd).items()
            if not (k.endswith('num_batches_tracked') or k.endswith('.mask'))}


def _load_report(model: nn.Module, sd: Dict[str, torch.Tensor], strict: bool,
                 allow_missing_prefixes: Tuple[str, ...] = ()
                 ) -> Dict[str, List[str]]:
    allow = tuple(allow_missing_prefixes)
    result = model.load_state_dict(sd, strict=strict and not allow)
    missing = [k for k in result.missing_keys if not k.startswith(allow)] \
        if allow else list(result.missing_keys)
    unexpected = list(result.unexpected_keys)
    if strict and (missing or unexpected):
        raise RuntimeError(f'Missing key(s): {missing[:8]}; unexpected '
                           f'key(s): {unexpected[:8]}')
    return dict(missing=missing, unexpected=unexpected)


def load_checkpoint_report(model: nn.Module, path: str, strict: bool = True,
                           allow_missing_prefixes: Tuple[str, ...] = ()
                           ) -> Dict[str, List[str]]:
    """Load a reference ``.pth`` (or one this port saved) into ``model``
    and return ``{'missing': [...], 'unexpected': [...]}``: the model's keys
    the checkpoint lacks and the checkpoint's keys the model lacks.

    ``num_batches_tracked`` and the RealNVP ``mask`` buffers are constants
    the model does not keep as state, so they are dropped first, as the JAX
    bridge drops them. With ``strict`` any missing or unexpected key raises;
    without it the missing keys keep the model's values and the unexpected
    ones are ignored, as the JAX bridge's ``merge_into_variables(strict=
    False)`` does. Model keys that start with one of
    ``allow_missing_prefixes`` may be missing even under ``strict`` and are
    left out of the report, as in the JAX bridge (whose prefixes name flax
    paths where these name the port's state-dict keys). A shape mismatch
    always raises."""
    return _load_report(model, _read_state_dict(path), strict,
                        allow_missing_prefixes)


def load_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """``load_checkpoint_report`` with ``strict=True``; returns the
    model."""
    load_checkpoint_report(model, path, strict=True)
    return model


def load_mspn_pretrained(model: nn.Module, path: str
                         ) -> Dict[str, List[str]]:
    """Load an MSPN COCO pretrained backbone into ``model.backbone`` (ref
    mspn_mmpose.py:669-680): only the checkpoint's ``backbone.`` keys,
    non-strict; the report's ``missing`` lists what stays at init."""
    sd = {k: v for k, v in _read_state_dict(path).items()
          if k.startswith('backbone.')}
    return _load_report(model, sd, strict=False)


def export_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict in the reference's keys and layouts, on the
    CPU, floating tensors in f32 (what the JAX bridge reads into its f32
    tree); 0-d ``Scale`` parameters keep their () shape."""
    return {k: (v.detach().float() if v.is_floating_point()
                else v.detach()).cpu().clone()
            for k, v in model.state_dict().items()}


def save_torch_checkpoint(model: nn.Module, path: str, meta: Dict = None):
    """Write a ``.pth`` of ``{'state_dict', 'meta'}`` with the reference
    layout (JAX ``torch_bridge.save_torch_checkpoint``): what the JAX
    package's ``load_torch_checkpoint`` and this port's ``load_checkpoint``
    read."""
    torch.save(dict(state_dict=export_state_dict(model), meta=meta or {}),
               path)
