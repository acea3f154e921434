"""Eval BatchNorm with the residual add and the ReLU after it, in one pass
(CUDA, sm_90a), and its plain version.

Replaces no TPU kernel: XLA fuses the JAX backbones' eval BatchNorm into
the convolutions around it. ``bn_act`` computes

    out = act(bn(x) [+ residual])

for an NCHW ``x``, with ``bn`` the eval BatchNorm of the module's f32
weight, bias, running mean and running variance: per channel ``scale =
weight * (1 / sqrt(var + eps))`` and ``shift = bias - mean * scale``, then
``y = x * scale + shift`` in f32, rounded to ``x.dtype``; with a residual
``y + residual`` in f32, rounded once more; then the ReLU where asked.

On a CUDA tensor the wrapper launches the hand-written kernel
(``das_tpu_torch/csrc/bn_act.cu``), which takes a channels-last bf16 ``x``
(and residual), or raises; the kernel's result is the plain version's, bit
for bit. On a CPU tensor it runs the plain version, ``bn_act_plain``,
which also takes f32. Neither has a backward: the call raises where
autograd would record it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .cuda_build import (FLOAT, INT, LONG, PTR, CudaLibrary, check_launch,
                         on_device, raw_stream)

LIB = CudaLibrary('bn_act.cu', {
    'bn_act_forward': [PTR] * 7 + [LONG, INT, FLOAT, INT, PTR]})

# Kernel launches since the last reset; the main path's run reads it.
launches = 0


def affine(weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
           var: torch.Tensor, eps: float):
    """(scale, shift) of the eval BatchNorm, (C,) f32 each, rounded as the
    kernel rounds them."""
    scale = torch.reciprocal(torch.sqrt(var.float() + eps)) * weight.float()
    return scale, bias.float() - mean.float() * scale


def bn_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5,
                 residual: Optional[torch.Tensor] = None,
                 relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, for f32 or bf16 NCHW ``x`` of
    any layout; shapes as ``bn_act``."""
    scale, shift = affine(weight, bias, mean, var, eps)
    y = (x.float() * scale[:, None, None] + shift[:, None, None]).to(x.dtype)
    if residual is not None:
        y = (y.float() + residual.float()).to(x.dtype)
    return F.relu(y) if relu else y


def records(*ts) -> bool:
    """Whether autograd would record a call on ``ts`` (None skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def bn_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5,
           residual: Optional[torch.Tensor] = None,
           relu: bool = False) -> torch.Tensor:
    """act(bn(x) [+ residual]) in ``x.dtype``.

    Args: x (N,C,H,W); weight, bias, mean, var (C,) f32, the BatchNorm's
    parameters and running statistics; residual None or like ``x``;
    ``relu`` applies the ReLU last.

    CPU tensors run ``bn_act_plain``; CUDA tensors launch the kernel, which
    takes bf16 ``x`` and residual in the channels-last layout."""
    global launches
    if records(x, residual, weight, bias):
        raise RuntimeError('bn_act has no backward: call the BatchNorm '
                           'where autograd records')
    if x.device.type == 'cpu':
        return bn_act_plain(x, weight, bias, mean, var, eps, residual, relu)
    if x.device.type != 'cuda':
        raise ValueError(f'no BatchNorm kernel for device {x.device}')
    if x.dim() != 4:
        raise ValueError(f'x must be (N,C,H,W), got {tuple(x.shape)}')
    N, C, H, W = x.shape
    dev = x.device
    for name, t in (('x', x), ('residual', residual)):
        if t is None:
            continue
        if t.dtype != torch.bfloat16:
            raise TypeError(f'the kernel takes a bf16 {name} (got {t.dtype})')
        if t.device != dev or t.shape != x.shape:
            raise ValueError(f'{name} is {tuple(t.shape)} on {t.device}, '
                             f'expected {tuple(x.shape)} on {dev}')
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f'the kernel takes a channels-last {name}')
    for name, t in (('weight', weight), ('bias', bias), ('mean', mean),
                    ('var', var)):
        if (t.dtype != torch.float32 or t.device != dev or t.shape != (C,)
                or not t.is_contiguous()):
            raise ValueError(f'{name} must be ({C},) f32 contiguous on '
                             f'{dev}, got {tuple(t.shape)} {t.dtype} on '
                             f'{t.device}')
    out = torch.empty_like(x, memory_format=torch.channels_last)
    lib = LIB.load()
    with on_device(dev):
        err = lib.bn_act_forward(
            x.data_ptr(), 0 if residual is None else residual.data_ptr(),
            out.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), var.data_ptr(), N * H * W, C, float(eps),
            int(relu), raw_stream(dev))
    check_launch('bn_act', err)
    launches += 1
    return out
