"""Save and resume training, the port's counterpart of
``das_tpu/checkpoint/orbax_io.py::CheckpointManager`` (replaces mmcv
CheckpointHook, ref exp_panoptic.py:214-217: interval=1,
max_keep_ckpts=20), without orbax.

One file a step, ``step_<step>.pt`` in the directory, written by
``torch.save`` to a temporary name and then renamed, so a file that is
there is whole. It holds the model's state dict (the f32 master weights and
the BatchNorm statistics, as the model keeps them), the momentum by
parameter name, the optimizer's ``count`` and the ``step``. At most
``max_keep`` files stay; a save past that removes the oldest.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Union

import torch

from ..parallel.train_step import TrainState

_NAME = re.compile(r'^step_(\d+)\.pt$')


class CheckpointManager:
    def __init__(self, directory: str, max_keep: int = 20):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_keep = max_keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f'step_{int(step):08d}.pt')

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, step: int) -> str:
        """Write ``state`` as step ``step``; returns the file's path."""
        payload = dict(
            step=int(state.step),
            model={k: v.detach().cpu()
                   for k, v in state.model.state_dict().items()},
            momentum={k: v.detach().cpu()
                      for k, v in state.opt_state['momentum'].items()},
            count=int(state.opt_state['count']))
        path = self.path(step)
        tmp = path + '.tmp'
        torch.save(payload, tmp)
        os.replace(tmp, path)
        steps = self.all_steps()
        for old in steps[:max(len(steps) - self.max_keep, 0)]:
            os.remove(self.path(old))
        return path

    def restore(self, state: TrainState,
                step_or_path: Union[None, int, str] = None) -> TrainState:
        """``state`` with the model, momentum, ``count`` and ``step`` of a
        checkpoint: the latest (``None`` or ``'latest'``), a step (an int or
        a digit string), or a file's path. The model's tensors are loaded
        in place (strict); the momentum goes to each parameter's device."""
        if step_or_path is None or step_or_path == 'latest':
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f'no checkpoint in {self.directory}')
            path = self.path(step)
        elif isinstance(step_or_path, int) or str(step_or_path).isdigit():
            path = self.path(int(step_or_path))
        else:
            path = str(step_or_path)
        ckpt = torch.load(path, map_location='cpu', weights_only=True)
        state.model.load_state_dict(ckpt['model'], strict=True)
        params = dict(state.model.named_parameters())
        momentum = {k: v.to(params[k].device)
                    for k, v in ckpt['momentum'].items()}
        return TrainState(ckpt['step'], state.model,
                          dict(momentum=momentum, count=ckpt['count']))
