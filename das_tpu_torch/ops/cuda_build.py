"""Build the port's CUDA sources, load them with ``ctypes``, and check
what their wrappers hand them.

Each source under ``das_tpu_torch/csrc/`` exposes a plain C interface. It
is compiled with ``nvcc`` for ``sm_90a`` into a shared library at first use,
once per content of the source and of the headers beside it (``*.cuh``),
into ``build/das_tpu_torch/`` (listed in ``.gitignore``). ``build_all``
starts one ``nvcc`` per source, all at once, and waits for them together.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'das_tpu_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

PTR = ctypes.c_void_p      # a tensor's data_ptr() or the CUDA stream
INT = ctypes.c_int
LONG = ctypes.c_longlong
FLOAT = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cand = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(cand):
        return cand
    raise RuntimeError('nvcc not found: the port\'s kernels are built from '
                       f'{CSRC} with the CUDA toolkit')


class CudaLibrary:
    """One CUDA source, built into a shared library and loaded on demand.

    ``functions`` maps each exported C function to its ctypes argument
    types; every function returns ``cudaGetLastError()`` as an int.
    """

    def __init__(self, source: str, functions: Dict[str, List]):
        self.source = CSRC / source
        self.functions = functions
        self.build_log = ''
        self._lib = None
        self._lock = threading.Lock()

    def so_path(self) -> Path:
        src = self.source.read_bytes() + b''.join(
            h.read_bytes() for h in sorted(CSRC.glob('*.cuh')))
        tag = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()) \
            .hexdigest()[:16]
        return BUILD_DIR / f'lib{self.source.stem}_{tag}.so'

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` unless the library is built; None if it is."""
        so = self.so_path()
        if so.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._tmp = so.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(self._tmp), str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: Optional[subprocess.Popen]) -> Path:
        so = self.so_path()
        if proc is None:
            return so
        self.build_log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {self.source.name} '
                               f'({proc.returncode}):\n{self.build_log}')
        os.replace(self._tmp, so)
        return so

    def load(self):
        """Build if needed, load, and return the ctypes library."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.finish_build(self.start_build())))
                for name, argtypes in self.functions.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
        return self._lib

    def registers(self) -> str:
        """The ``ptxas`` lines of the last build that give each kernel's
        registers and shared memory."""
        return ' | '.join(ln.strip() for ln in self.build_log.splitlines()
                          if 'registers' in ln)


def build_all(libs: Sequence[CudaLibrary]) -> float:
    """Compile every library in parallel (one ``nvcc`` each), load them,
    and return the seconds taken."""
    t = time.perf_counter()
    procs = [lib.start_build() for lib in libs]
    for lib, proc in zip(libs, procs):
        lib.finish_build(proc)
    for lib in libs:
        lib.load()
    return time.perf_counter() - t


def check_tensor(name: str, t: torch.Tensor, shape, dtype, device):
    """Raise unless ``t`` has the device, shape, dtype and contiguity the
    kernel takes."""
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                         f'expected {tuple(shape)}')
    if t.dtype != dtype:
        raise TypeError(f'{name} is {t.dtype}, expected {dtype}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def raw_stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``, for a ctypes
    call. ``torch.cuda.current_stream`` builds a Stream object on every
    call; the binding it wraps returns the handle alone."""
    get = getattr(torch._C, '_cuda_getCurrentRawStream', None)
    if get is not None:
        return get(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def on_device(dev: torch.device):
    """The context of a ctypes launch on ``dev``: the CUDA runtime launches
    on its current device whatever stream it is handed, so ``dev`` is made
    current for the call where it is not already (a bare check where it
    is: K4's host time a call counts)."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def check_launch(name: str, err: int):
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {err}')
