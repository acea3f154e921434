"""ctypes bindings for the port's native host runtime (``csrc/das_host.cpp``),
the counterpart of ``das_tpu/datasets/native.py``.

The library gives the host pipeline its C++ paths: the bilinear resize of
``Resize`` / ``ResizePose``, the affine warp of ``GlobalRotScaleTransPose``
(both of a float32 HxWx3 image, as cv2 computes them up to rounding) and a
fused normalize + BGR->RGB + pad into a batch slot. It is built at first use
with ``g++ -O3 -march=native -fPIC -shared`` (the flags of the JAX package's
``csrc/build.sh``) into ``build/das_tpu_torch/``, named by a hash of the
source, the flags and the instruction set ``-march=native`` selects, so a
library built on another host is never loaded here.

There is no fallback: where ``g++`` is missing or the build fails, the call
raises with the compiler's output. The transforms take cv2 only where the
JAX package's own condition sends an image there (not float32, or not HxWx3).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'das_host.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'das_tpu_torch'
GXX_FLAGS = ['-O3', '-march=native', '-fPIC', '-shared']

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_INT = ctypes.c_int
_ARGTYPES = {
    'das_normalize_pad': [_F32P, _INT, _INT, _F32P, _INT, _INT, _F32P, _F32P,
                          _INT],
    'das_affine_warp': [_F32P, _INT, _INT, _F64P, _F32P, _INT, _INT, _F32P],
    'das_resize_bilinear': [_F32P, _INT, _INT, _F32P, _INT, _INT],
}


def _gxx() -> str:
    found = shutil.which('g++')
    if found is None:
        raise RuntimeError(f'g++ not found: the host library is built from '
                           f'{SOURCE} at first use')
    return found


def so_path() -> Path:
    """Where the library of this source, these flags and this host's
    ``-march=native`` lives."""
    target = subprocess.run([_gxx(), '-march=native', '-Q', '--help=target'],
                            capture_output=True, text=True)
    if target.returncode != 0:
        raise RuntimeError(f'g++ -march=native failed ({target.returncode}):'
                           f'\n{target.stdout}{target.stderr}')
    tag = hashlib.sha256(SOURCE.read_bytes() + ' '.join(GXX_FLAGS).encode()
                         + target.stdout.encode()).hexdigest()[:16]
    return BUILD_DIR / f'libdas_host_{tag}.so'


def build() -> Path:
    """Compile the library unless it is there; returns its path. A failed
    build raises with g++'s output."""
    so = so_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f'.{os.getpid()}.tmp')
    proc = subprocess.run([_gxx(), *GXX_FLAGS, '-o', str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'g++ failed on {SOURCE.name} ({proc.returncode}):'
                           f'\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            _LIB = lib
    return _LIB


def available() -> bool:
    """True once the library is built and loaded (the first call builds
    it). It never answers False: a missing g++ or a failed build raises, so
    no transform takes cv2 because the library is missing."""
    _load()
    return True


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _hwc3(src: np.ndarray) -> np.ndarray:
    src = np.ascontiguousarray(src, np.float32)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f'the host library takes HxWx3 images, got '
                         f'{src.shape}')
    return src


def _three(name: str, values) -> np.ndarray:
    """``values`` as 3 contiguous float32s (one a channel)."""
    out = np.ascontiguousarray(values, np.float32).reshape(-1)
    if out.shape != (3,):
        raise ValueError(f'{name} needs one value a channel (3), got '
                         f'{out.shape[0]}')
    return out


def normalize_pad_into(src: np.ndarray, dst: np.ndarray,
                       mean: np.ndarray, std: np.ndarray,
                       to_rgb: bool = True) -> None:
    """Fused (src - mean)/std [+BGR->RGB] + zero-pad, writing into the
    (PH, PW, 3) float32 batch slot ``dst``."""
    lib = _load()
    src = _hwc3(src)
    mean, std = _three('mean', mean), _three('std', std)
    if not (dst.flags['C_CONTIGUOUS'] and dst.dtype == np.float32
            and dst.ndim == 3 and dst.shape[2] == 3
            and dst.shape[0] >= src.shape[0]
            and dst.shape[1] >= src.shape[1]):
        raise ValueError(f'dst must be a C-contiguous float32 (PH, PW, 3) '
                         f'slot that holds {src.shape}, got {dst.shape} '
                         f'{dst.dtype}')
    lib.das_normalize_pad(_fp(src), src.shape[0], src.shape[1],
                          _fp(dst), dst.shape[0], dst.shape[1],
                          _fp(mean), _fp(std), int(to_rgb))


def affine_warp(src: np.ndarray, trans: np.ndarray, out_hw,
                border) -> np.ndarray:
    """cv2.warpAffine(INTER_LINEAR, constant border) equivalent."""
    lib = _load()
    oh, ow = out_hw
    src = _hwc3(src)
    dst = np.empty((oh, ow, 3), np.float32)
    t = np.ascontiguousarray(np.asarray(trans, np.float64)[:2].reshape(6))
    b = _three('border', border)
    lib.das_affine_warp(_fp(src), src.shape[0], src.shape[1],
                        t.ctypes.data_as(_F64P), _fp(dst), oh, ow, _fp(b))
    return dst


def resize_bilinear(src: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize(INTER_LINEAR) equivalent, float32 HWC3."""
    lib = _load()
    oh, ow = out_hw
    src = _hwc3(src)
    dst = np.empty((oh, ow, 3), np.float32)
    lib.das_resize_bilinear(_fp(src), src.shape[0], src.shape[1],
                            _fp(dst), oh, ow)
    return dst
