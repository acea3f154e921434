"""The reference's backbones, one module a type: ``<type>.py`` in this
directory, found by a configuration's ``model.backbone.type``. A module
gives, for the configuration's ``backbone`` section ``b``:

- ``build(b)``: the backbone, an ``nn.Module`` whose ``forward(x, remat)``
  takes a normalised NCHW batch and returns its four maps, at strides 4,
  8, 16 and 32, the lowest stride first; with ``remat`` it checkpoints
  its own regions. What it freezes, its ``train()`` keeps in eval.
- ``out_channels(b)``: the four maps' channels, the FPN's inputs.
- ``frozen_prefixes(b)``: the prefixes, in the model's keys
  (``backbone.``...), of the parameters that training holds still.
- ``REPO_KEYS``: the keys of ``b`` that equal those of the repo
  configuration's backbone.

It builds from ``model``'s layers (``Conv``, ``BatchNorm``, ``GroupNorm``,
``ConvModule``), so that the seeded weights and the training check find
its norms by their type.
"""

from __future__ import annotations

import importlib
import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict


def find(b: Dict) -> ModuleType:
    """The module of the backbone section ``b``'s ``type``."""
    kind = b.get('type')
    if not kind:
        raise KeyError("the configuration's model.backbone names no 'type' "
                       f'(a module of {Path(__file__).parent})')
    name = f'{__name__}.{kind}'
    if not kind.isidentifier() or importlib.util.find_spec(name) is None:
        raise ModuleNotFoundError(
            f'no reference backbone of type {kind!r}: '
            f'{Path(__file__).parent / kind}.py is missing', name=name)
    return importlib.import_module(name)
