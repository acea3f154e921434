from .config import Config, ConfigDict, merge_dict, wrap_cfg
from .registry import (BACKBONES, HEADS, MODELS, NECKS, Registry,
                       build_from_cfg)

__all__ = [
    'Config', 'ConfigDict', 'merge_dict', 'wrap_cfg', 'Registry',
    'build_from_cfg', 'MODELS', 'BACKBONES', 'NECKS', 'HEADS'
]
