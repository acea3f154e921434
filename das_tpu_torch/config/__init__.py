from .config import Config, ConfigDict, merge_dict, wrap_cfg
from .registry import (BACKBONES, DATASETS, HEADS, MODELS, NECKS,
                       PIPELINES, Registry, build_from_cfg)

__all__ = [
    'Config', 'ConfigDict', 'merge_dict', 'wrap_cfg', 'Registry',
    'build_from_cfg', 'MODELS', 'BACKBONES', 'NECKS', 'HEADS', 'DATASETS',
    'PIPELINES'
]
