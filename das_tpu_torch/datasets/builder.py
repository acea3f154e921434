"""Dataset builders, the port's copy of ``das_tpu/datasets/builder.py``
(ref: mmdet3d/datasets/builder.py:20-43): list-of-configs ->
ConcatDataset; RepeatDataset wrapper."""

from __future__ import annotations

from ..config.registry import DATASETS, build_from_cfg
from .base import ConcatDataset, RepeatDataset


def build_dataset(cfg):
    if isinstance(cfg, (list, tuple)):
        return ConcatDataset([build_dataset(c) for c in cfg])
    cfg = dict(cfg)
    if cfg.get('type') == 'RepeatDataset':
        return RepeatDataset(build_dataset(cfg['dataset']),
                             cfg.get('times', 1))
    if cfg.get('type') == 'ConcatDataset':
        return ConcatDataset([build_dataset(c) for c in cfg['datasets']])
    return build_from_cfg(cfg, DATASETS)
