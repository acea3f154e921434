#!/usr/bin/env python3
"""Check the das_tpu_torch port on one NVIDIA H100: build it, then run its
card tests.

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

1. environment: torch/CUDA versions, the card and its capability (9, 0)
   required, ``nvidia-smi`` name and power limit, nvcc, triton and cv2, and
   ``utils/collect_env.py``'s report;
2. build: the host library with g++, then every kernel of the path from
   the repository's sources, one ``nvcc`` per source, all started
   together;
3. the ``cuda`` tests of CARD_TESTS under ``pytest --noconftest -m cuda``
   (the card host has no JAX): each hand kernel against its plain version
   (``tests/test_torch_cuda.py``), the CUDA graphs of the serving head
   (``tests/test_torch_graphs.py``), the program's spans
   (``tests/test_torch_tracing.py``), and the main paths and every entry
   point at full width (``tests/test_torch_card_paths.py``).

Each line of phases 1-2 carries the seconds since the start. Any failure
exits nonzero; the last line is ``{"ok": ..., "device": {...}}``. Times of
a kernel alone come from ``python -m das_tpu_torch.tools.profile_kernels``,
those of requests and steps from the benchmark (``python3 -m dasbench.run``).
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CARD_TESTS = ('tests/test_torch_cuda.py', 'tests/test_torch_graphs.py',
              'tests/test_torch_tracing.py', 'tests/test_torch_card_paths.py')
STARTED = time.perf_counter()


def phase(name, msg):
    """One line of a phase, with the seconds since the script started."""
    print(f'[{name} +{time.perf_counter() - STARTED:.1f}s] {msg}',
          flush=True)


def environment():
    """Phase 1. Returns the card's name, or raises SystemExit where there
    is no card of capability (9, 0)."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device '
                         '(torch.cuda.is_available() is False)')
    name = torch.cuda.get_device_name(0)
    cap = tuple(torch.cuda.get_device_capability(0))
    phase('env', f'python {sys.version.split()[0]} torch {torch.__version__}'
          f' cuda {torch.version.cuda} device {name!r} capability {cap} '
          f'count {torch.cuda.device_count()}')
    if cap != (9, 0):
        raise SystemExit(f'chip_smoke: needs compute capability (9, 0), '
                         f'got {cap}')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    nvcc = subprocess.run(['bash', '-lc', 'command -v nvcc || ls '
                           '/usr/local/cuda/bin/nvcc'], capture_output=True,
                          text=True).stdout.strip()
    versions = []
    for mod in ('triton', 'cv2'):
        try:
            versions.append(f'{mod} {__import__(mod).__version__}')
        except ImportError:
            versions.append(f'{mod} absent')
    phase('env', f'nvcc {nvcc or "absent"}; ' + '; '.join(versions))
    from das_tpu_torch.utils.collect_env import collect_env
    phase('env', 'collect_env: ' + '; '.join(
        f'{k}: {v}' for k, v in collect_env().items()))
    return name


def build():
    """Phase 2: the host library (g++, ``datasets/native.py``), then every
    CUDA source (one nvcc each, started together)."""
    from das_tpu_torch.datasets import native
    from das_tpu_torch.ops import (conv_gn, cuda_build, dcn_shift, gather,
                                   oks_nms)
    libs = [dcn_shift.LIB, conv_gn.LIB, oks_nms.LIB, gather.LIB]
    t = time.perf_counter()
    so = native.build()
    if not native.available():
        raise SystemExit('chip_smoke: the host library did not load')
    host_s = time.perf_counter() - t
    secs = cuda_build.build_all(libs)
    phase('build', ', '.join(lib.source.name for lib in libs)
          + f' built (one nvcc each, in parallel) and loaded in {secs:.2f} s;'
          f' host library {os.path.relpath(so, HERE)} (g++ '
          f'{" ".join(native.GXX_FLAGS)}) built and loaded in {host_s:.2f} s')
    for lib in libs:
        phase('build', f'{lib.source.name}: {lib.registers()}')


def card_tests():
    """Phase 3: the card tests in a child pytest; its exit code."""
    cmd = [sys.executable, '-m', 'pytest', '--noconftest', '-m', 'cuda',
           '-p', 'no:cacheprovider', '-q', '-rfE', '--durations=20',
           *CARD_TESTS]
    phase('tests', ' '.join(cmd[1:]))
    code = subprocess.run(cmd, cwd=HERE).returncode
    phase('tests', f'pytest exit {code}')
    return code


def main():
    os.chdir(HERE)
    sys.path.insert(0, HERE)
    name = environment()
    build()
    code = card_tests()
    import torch
    print(json.dumps({'ok': code == 0, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 1 if code else 0


if __name__ == '__main__':
    sys.exit(main())
