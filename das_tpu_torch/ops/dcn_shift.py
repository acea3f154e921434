"""DCNv2 shift-expansion kernel (CUDA, sm_90a) and its plain version.

Counterpart of ``das_tpu/ops/pallas_dcn.py::deform_conv_shift_pallas``.
``deform_conv_shift`` computes the same function as that kernel: NHWC,
K=3, pad 1, stride 1, one deform group. Each tap's (dy, dx) offset is
clamped to ``[-radius, radius]``, the tap is the hat-weighted sum of the
zero-padded input over the ``(2r+2)^2`` integer window, it is scaled by the
mask and contracted with ``W_k``; the nine contractions accumulate in f32,
the sum is cast to ``x.dtype`` and the bias is added in ``x.dtype``.

On a CUDA tensor the wrapper launches the hand-written kernel
(``das_tpu_torch/csrc/dcn_shift.cu``) or raises. On a CPU tensor it runs
the plain PyTorch version, ``deform_conv_shift_plain``. The kernel is built
with ``nvcc`` at first use into ``build/das_tpu_torch/`` and loaded with
``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'dcn_shift.cu'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'das_tpu_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

# Kernel launches since the last reset; the main path's run reads it.
launches = 0

_lib = None
_lib_lock = threading.Lock()
build_log = ''


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cand = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(cand):
        return cand
    raise RuntimeError('nvcc not found: the DCN shift kernel is built from '
                       f'{SOURCE} with the CUDA toolkit')


def build() -> Path:
    """Compile the kernel (once per source content) and return the .so."""
    global build_log
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f'libdcn_shift_{tag}.so'
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{build_log}')
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.dcn_shift_forward
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def load_seconds() -> float:
    """Build (if needed) and load the kernel; return the seconds taken."""
    t = time.perf_counter()
    _load()
    return time.perf_counter() - t


def deform_conv_shift_plain(x: torch.Tensor, offset: torch.Tensor,
                            mask: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor], K: int = 3,
                            padding: int = 1, radius: int = 1
                            ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the Pallas kernel's semantics).

    Per tap: the window sum accumulates in ``x.dtype``, is scaled by the
    mask in ``x.dtype`` and contracted with f32 accumulation across taps
    (bf16 products are exact in f32). Shapes as ``deform_conv_shift``.
    """
    N, H, W, Cin = x.shape
    Cout = weight.shape[-1]
    P = padding + radius + 1
    dt = x.dtype
    xp = torch.nn.functional.pad(x, (0, 0, P, P, P, P))
    off = offset.float()
    m = mask.to(dt)
    w = weight.to(dt).reshape(K * K, Cin, Cout).float()
    r = float(radius)
    out = torch.zeros((N * H * W, Cout), dtype=torch.float32,
                      device=x.device)
    for k in range(K * K):
        kh, kw = divmod(k, K)
        dy = off[..., 2 * k].clamp(-r, r)[..., None] + (kh - padding)
        dx = off[..., 2 * k + 1].clamp(-r, r)[..., None] + (kw - padding)
        acc = torch.zeros((N, H, W, Cin), dtype=dt, device=x.device)
        for iy in range(kh - padding - radius, kh - padding + radius + 2):
            wy = (1.0 - (iy - dy).abs()).clamp_min(0.0)
            for ix in range(kw - padding - radius,
                            kw - padding + radius + 2):
                wgt = wy * (1.0 - (ix - dx).abs()).clamp_min(0.0)
                acc = acc + xp[:, iy + P:iy + P + H, ix + P:ix + P + W] \
                    * wgt.to(dt)
        acc = acc * m[..., k:k + 1]
        out = out + acc.reshape(-1, Cin).float() @ w[k]
    out = out.reshape(N, H, W, Cout).to(dt)
    if bias is not None:
        out = out + bias.to(dt)
    return out


def _check(name: str, t: torch.Tensor, shape, dtype, device):
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, x on {device}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                         f'expected {tuple(shape)}')
    if t.dtype != dtype:
        raise TypeError(f'{name} is {t.dtype}, expected {dtype}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def deform_conv_shift(x: torch.Tensor, offset: torch.Tensor,
                      mask: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor], K: int = 3,
                      padding: int = 1, radius: int = 1) -> torch.Tensor:
    """DCNv2 shift expansion.

    Args: x (N,H,W,Cin) NHWC; offset (N,H,W,2*K*K) per-tap (dy, dx); mask
    (N,H,W,K*K) already sigmoided; weight (K,K,Cin,Cout); bias (Cout,) or
    None. Returns (N,H,W,Cout) in ``x.dtype``.

    CPU tensors run ``deform_conv_shift_plain``; CUDA tensors launch the
    kernel, which takes K=3, padding=1, radius 1 or 2, x in f32 or bf16
    and a contiguous x. As the TPU wrapper does, offset is read as f32 and
    mask, weight and bias in ``x.dtype``.
    """
    global launches
    if x.device.type == 'cpu':
        return deform_conv_shift_plain(x, offset, mask, weight, bias,
                                       K, padding, radius)
    if x.device.type != 'cuda':
        raise ValueError(f'no DCN shift kernel for device {x.device}')
    if K != 3 or padding != 1:
        raise ValueError(f'the kernel takes K=3, padding=1 (got K={K}, '
                         f'padding={padding})')
    if radius not in (1, 2):
        raise ValueError(f'the kernel takes radius 1 or 2 (got {radius})')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'the kernel takes f32 or bf16 x (got {x.dtype})')
    if x.dim() != 4:
        raise ValueError(f'x must be (N,H,W,Cin), got {tuple(x.shape)}')
    N, H, W, Cin = x.shape
    Cout = weight.shape[-1]
    dev, dt = x.device, x.dtype
    _check('x', x, (N, H, W, Cin), dt, dev)
    offset = offset.to(torch.float32).contiguous()
    mask = mask.to(dt).contiguous()
    w = weight.to(dt).contiguous()
    _check('offset', offset, (N, H, W, 18), torch.float32, dev)
    _check('mask', mask, (N, H, W, 9), dt, dev)
    _check('weight', w, (3, 3, Cin, Cout), dt, dev)
    if bias is not None:
        bias = bias.to(dt).contiguous()
        _check('bias', bias, (Cout,), dt, dev)
    out = torch.empty((N, H, W, Cout), dtype=dt, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dcn_shift_forward(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            N, H, W, Cin, Cout, radius, int(dt == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f'dcn_shift kernel launch failed: CUDA error {err}')
    launches += 1
    return out
