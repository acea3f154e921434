"""Environment report, the port's counterpart of
``das_tpu/utils/collect_env.py`` (ref: mmdet3d/utils/collect_env.py).

Run as ``python -m das_tpu_torch.utils.collect_env``: one ``key: value``
line each for Python, the platform, torch, the CUDA runtime and cuDNN that
torch was built with, each card's name and compute capability, the cards'
name and power limit as ``nvidia-smi`` gives them, the ``nvcc`` that
``ops/cuda_build.py`` builds the kernels with, the ``g++`` that builds the
host library, numpy, cv2 and das_tpu_torch.
"""

from __future__ import annotations

import platform
import shutil
import subprocess
import sys
from typing import Dict, List


def _first_line(cmd: List[str], last: bool = False) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f'unavailable ({e})'
    lines = [ln.strip() for ln in proc.stdout.splitlines() if ln.strip()]
    if proc.returncode != 0 or not lines:
        return f'unavailable (exit {proc.returncode})'
    return lines[-1] if last else lines[0]


def collect_env() -> Dict[str, str]:
    import torch
    env = {}
    env['sys.platform'] = sys.platform
    env['Python'] = sys.version.replace('\n', '')
    env['Platform'] = platform.platform()
    env['torch'] = torch.__version__
    env['CUDA runtime'] = str(torch.version.cuda)
    env['cuDNN'] = str(torch.backends.cudnn.version()
                       if torch.backends.cudnn.is_available() else None)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    env['CUDA devices'] = str(count)
    for i in range(count):
        env[f'GPU {i}'] = (f'{torch.cuda.get_device_name(i)}, capability '
                           f'{torch.cuda.get_device_capability(i)}')
    env['nvidia-smi'] = (_first_line(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader']) if shutil.which('nvidia-smi')
        else 'not found')
    from ..ops.cuda_build import _nvcc
    try:
        nvcc = _nvcc()
        env['nvcc'] = f'{nvcc}: {_first_line([nvcc, "--version"], True)}'
    except RuntimeError:
        env['nvcc'] = 'not found'
    gxx = shutil.which('g++')
    env['g++'] = f'{gxx}: {_first_line([gxx, "--version"])}' if gxx \
        else 'not found'
    for mod in ('numpy', 'cv2'):
        try:
            m = __import__(mod)
            env[mod] = getattr(m, '__version__', 'unknown')
        except ImportError:
            env[mod] = 'not installed'
    import das_tpu_torch
    env['das_tpu_torch'] = das_tpu_torch.__version__
    return env


if __name__ == '__main__':
    for k, v in collect_env().items():
        print(f'{k}: {v}')
