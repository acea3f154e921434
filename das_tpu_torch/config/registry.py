"""String-typed component registries.

Preserves the OpenMMLab-style registry API the reference exposes
(ref: mmdet3d/models/builder.py:75, ``@DETECTORS.register_module()`` at
detectors/das.py:5) so configs that say ``dict(type='DASHead', ...)`` build
the port's modules. The port's own copy of ``das_tpu/config/registry.py``,
with its own registry instances.
"""

from __future__ import annotations

from typing import Callable, Dict


class Registry:
    def __init__(self, name: str):
        self.name = name
        self.module_dict: Dict[str, Callable] = {}

    def register_module(self):
        """Decorator ``@REG.register_module()``: register under the class
        name."""
        def _decorator(cls):
            if cls.__name__ in self.module_dict:
                raise KeyError(f'{cls.__name__} is already registered in '
                               f'{self.name}')
            self.module_dict[cls.__name__] = cls
            return cls

        return _decorator


def build_from_cfg(cfg: Dict, registry: Registry):
    """Instantiate ``registry[cfg['type']](**cfg_without_type)``."""
    if not isinstance(cfg, dict) or 'type' not in cfg:
        raise TypeError(f'cfg must be a dict with a "type" key, got {cfg!r}')
    args = dict(cfg)
    obj_type = args.pop('type')
    obj_cls = registry.module_dict.get(obj_type)
    if obj_cls is None:
        raise KeyError(f'{obj_type} is not in the {registry.name} registry; '
                       f'known: {sorted(registry.module_dict)}')
    return obj_cls(**args)


# The registries the serving and evaluation paths build from.
MODELS = Registry('models')          # detectors
BACKBONES = Registry('backbones')
NECKS = Registry('necks')
HEADS = Registry('heads')
DATASETS = Registry('datasets')
PIPELINES = Registry('pipelines')
