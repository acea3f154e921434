"""mmcv-style python-dict config loader.

Re-implements the config semantics the reference relies on
(ref: mmcv Config used via the reference tools/train.py:97-103 and
configs/das/exp_panoptic.py:1-5,14):

* a config file is a python module; every non-dunder top-level name is a key
* ``_base_`` is a str or list of str, resolved relative to the config file,
  merged depth-first (later bases win, the child wins over all bases)
* a dict containing ``_delete_: True`` replaces the base subtree instead of
  merging into it

Configs are plain nested dicts wrapped in an attribute-access
``ConfigDict``. This is the port's own copy of ``das_tpu/config/config.py``:
it reads the same config files unchanged.
"""

from __future__ import annotations

import copy
import importlib.util
import os
import sys
import types
from typing import Any, Dict, List, Union

BASE_KEY = '_base_'
DELETE_KEY = '_delete_'


class ConfigDict(dict):
    """Dict with attribute access, recursively wrapping nested dicts."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = wrap_cfg(value)

    def __setitem__(self, key, value):
        super().__setitem__(key, wrap_cfg(value))


def wrap_cfg(value: Any) -> Any:
    """Recursively wrap plain dicts in ConfigDict."""
    if isinstance(value, ConfigDict):
        return value
    if isinstance(value, dict):
        return ConfigDict({k: wrap_cfg(v) for k, v in value.items()})
    if isinstance(value, (list, tuple)):
        wrapped = [wrap_cfg(v) for v in value]
        return type(value)(wrapped) if isinstance(value, tuple) else wrapped
    return value


def _load_py_module(filename: str) -> Dict[str, Any]:
    """Execute a python config file and return its top-level dict."""
    filename = os.path.abspath(os.path.expanduser(filename))
    if not os.path.isfile(filename):
        raise FileNotFoundError(f'config file not found: {filename}')
    mod_name = '_das_cfg_' + os.path.basename(filename).replace('.', '_')
    spec = importlib.util.spec_from_file_location(mod_name, filename)
    module = importlib.util.module_from_spec(spec)
    # register temporarily so dataclass/pickling inside configs works
    sys.modules[mod_name] = module
    try:
        spec.loader.exec_module(module)
        cfg = {
            k: v
            for k, v in module.__dict__.items()
            if not k.startswith('__') and not isinstance(v, types.ModuleType)
            and not callable(v)
        }
    finally:
        sys.modules.pop(mod_name, None)
    return copy.deepcopy(cfg)


def merge_dict(base: Dict, child: Dict) -> Dict:
    """Merge ``child`` into ``base`` (child wins). Honors ``_delete_``.

    A dict of digit keys over a list merges into the list's elements
    (mmcv ``allow_list_keys`` semantics), as the JAX package's loader
    does."""
    base = copy.deepcopy(base)
    for key, value in child.items():
        if (isinstance(value, dict) and key in base
                and isinstance(base[key], list)
                and all(isinstance(k, str) and k.isdigit() for k in value)):
            lst = list(base[key])
            for k, v in value.items():
                i = int(k)
                if not 0 <= i < len(lst):
                    raise KeyError(
                        f'index {i} out of range for list {key!r} '
                        f'(len {len(lst)})')
                if isinstance(v, dict) and isinstance(lst[i], dict):
                    lst[i] = merge_dict(lst[i], v)
                else:
                    lst[i] = copy.deepcopy(v)
            base[key] = lst
        elif (isinstance(value, dict) and key in base
                and isinstance(base[key], dict)
                and not value.get(DELETE_KEY, False)):
            base[key] = merge_dict(base[key], value)
        else:
            if isinstance(value, dict):
                value = {k: v for k, v in value.items() if k != DELETE_KEY}
            base[key] = copy.deepcopy(value)
    return base


class Config:
    """A config file's merged dict with attribute access (the part of the
    mmcv ``Config`` surface the port uses)."""

    def __init__(self, cfg_dict: Dict = None):
        self._cfg_dict = wrap_cfg(cfg_dict or {})

    @staticmethod
    def fromfile(filename: str) -> 'Config':
        return Config(Config._file_to_dict(filename))

    @staticmethod
    def _file_to_dict(filename: str) -> Dict:
        cfg = _load_py_module(filename)
        base_files: Union[str, List[str]] = cfg.pop(BASE_KEY, [])
        if isinstance(base_files, str):
            base_files = [base_files]
        cfg_dir = os.path.dirname(os.path.abspath(filename))
        merged: Dict = {}
        for base in base_files:
            base_cfg = Config._file_to_dict(os.path.join(cfg_dir, base))
            merged = merge_dict(merged, base_cfg)
        merged = merge_dict(merged, cfg)
        return merged

    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Apply ``{'a.b.c': v}`` style overrides (``--cfg-options``)."""
        option_cfg: Dict = {}
        for full_key, v in options.items():
            d = option_cfg
            keys = full_key.split('.')
            for sub in keys[:-1]:
                d = d.setdefault(sub, {})
            d[keys[-1]] = v
        self._cfg_dict = wrap_cfg(merge_dict(dict(self._cfg_dict),
                                             option_cfg))

    def __getattr__(self, name: str) -> Any:
        if name.startswith('_'):
            raise AttributeError(name)
        return getattr(self._cfg_dict, name)

    def __getitem__(self, key):
        return self._cfg_dict[key]

    def __setattr__(self, name, value):
        if name.startswith('_'):
            super().__setattr__(name, value)
        else:
            self._cfg_dict[name] = value

    def to_dict(self) -> Dict:
        return copy.deepcopy(dict(self._cfg_dict))

    def dump(self) -> str:
        """The config as text (the checkpoint meta's ``config``)."""
        import pprint
        return pprint.pformat(self.to_dict(), width=100, sort_dicts=False)
