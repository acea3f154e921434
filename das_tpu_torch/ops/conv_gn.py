"""Fused 3x3 conv + GroupNorm + relu kernel (CUDA, sm_90a) and its plain
version.

Counterpart of ``das_tpu/ops/pallas_convgn.py::conv_gn_relu``, the eval
path of a bias-free ``ConvModule(3x3, GN, relu)``. ``conv_gn_relu``
computes the same function as that kernel: NHWC ``x``, HWIO ``(3,3,Cin,
Cout)`` weight, ``(Cout,)`` gamma and beta; the conv is 3x3 'same' with
zero padding and no bias, accumulated in f32 from ``x.dtype`` operands;
GroupNorm over ``groups`` contiguous channel groups takes its statistics
from the f32 accumulator, not from the rounded conv output (mean E[y],
variance E[y^2] - E[y]^2, both in f32, then ``rsqrt(var + eps)``); the
affine is in f32, then relu, then the result is rounded to ``x.dtype``.

On a CUDA tensor the wrapper launches the hand-written kernel
(``das_tpu_torch/csrc/conv_gn.cu``: a conv pass, on ``wgmma`` fed by TMA
for bf16 with Cin and Cout multiples of 8, a statistics pass and an apply
pass) or raises. On a CPU tensor it runs the plain PyTorch version,
``conv_gn_relu_plain``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda_build import (FLOAT, INT, PTR, CudaLibrary, check_launch,
                         check_tensor, on_device, raw_stream)

LIB = CudaLibrary('conv_gn.cu', {
    'conv_gn_relu_slots': [INT] * 6,
    'conv_gn_relu_forward': [PTR] * 8 + [INT] * 6 + [FLOAT, INT, PTR]})

# Kernel launches since the last reset; the main path's run reads it.
launches = 0


def conv_gn_relu_plain(x: torch.Tensor, weight: torch.Tensor,
                       gamma: torch.Tensor, beta: torch.Tensor,
                       groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the Pallas kernel's semantics).

    The conv runs in f32 on f32 copies of the ``x.dtype`` values (products
    of bf16 values are exact in f32), so the statistics see the unrounded
    conv output. Shapes as ``conv_gn_relu``.
    """
    N, H, W, Cin = x.shape
    Cout = weight.shape[-1]
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 weight.to(x.dtype).float().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1)                                 # (N,H,W,Cout)
    cg = Cout // groups
    inv_cnt = 1.0 / float(H * W * cg)
    s1 = y.sum(dim=(1, 2)).reshape(N, groups, cg).sum(-1)     # (N, G)
    s2 = (y * y).sum(dim=(1, 2)).reshape(N, groups, cg).sum(-1)
    mean = s1 * inv_cnt
    var = s2 * inv_cnt - mean * mean
    rstd = torch.rsqrt(var + eps)
    a = gamma.float() * rstd.repeat_interleave(cg, dim=1)     # (N, Cout)
    b = beta.float() - mean.repeat_interleave(cg, dim=1) * a
    out = torch.relu(y * a[:, None, None] + b[:, None, None])
    return out.to(x.dtype)


def conv_gn_relu(x: torch.Tensor, weight: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, groups: int = 32,
                 eps: float = 1e-5) -> torch.Tensor:
    """relu(GroupNorm(conv3x3_same(x))), no conv bias.

    Args: x (N,H,W,Cin) NHWC; weight (3,3,Cin,Cout) HWIO; gamma, beta
    (Cout,); ``groups`` divides Cout. Returns (N,H,W,Cout) in ``x.dtype``.

    CPU tensors run ``conv_gn_relu_plain``; CUDA tensors launch the kernel,
    which takes x in f32 or bf16, contiguous. As the TPU wrapper does, the
    weight is read in ``x.dtype`` and gamma and beta in f32.
    """
    global launches
    if x.device.type == 'cpu':
        return conv_gn_relu_plain(x, weight, gamma, beta, groups, eps)
    if x.device.type != 'cuda':
        raise ValueError(f'no conv+GN kernel for device {x.device}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'the kernel takes f32 or bf16 x (got {x.dtype})')
    if x.dim() != 4:
        raise ValueError(f'x must be (N,H,W,Cin), got {tuple(x.shape)}')
    N, H, W, Cin = x.shape
    Cout = weight.shape[-1]
    if groups < 1 or Cout % groups:
        raise ValueError(f'{groups} groups do not divide {Cout} channels')
    dev, dt = x.device, x.dtype
    check_tensor('x', x, (N, H, W, Cin), dt, dev)
    w = weight.to(dt).contiguous()
    check_tensor('weight', w, (3, 3, Cin, Cout), dt, dev)
    gamma = gamma.to(torch.float32).contiguous()
    beta = beta.to(torch.float32).contiguous()
    check_tensor('gamma', gamma, (Cout,), torch.float32, dev)
    check_tensor('beta', beta, (Cout,), torch.float32, dev)
    lib = LIB.load()
    is_bf16 = int(dt == torch.bfloat16)
    # the conv pass the call takes (wgmma fed by TMA, or element-wise tiles)
    # follows the alignment of x and the weight, and sets the slot count
    aligned = int((x.data_ptr() | w.data_ptr()) % 16 == 0)
    slots = lib.conv_gn_relu_slots(H, W, Cin, Cout, is_bf16, aligned)
    out = torch.empty((N, H, W, Cout), dtype=dt, device=dev)
    # the f32 scratch, one allocation: ws (N,H,W,Cout), part (N, slots,
    # groups, 2), stats (N, groups, 2), each from a 16-byte boundary
    sizes = [-(-n // 4) * 4 for n in (N * H * W * Cout,
                                      N * slots * groups * 2,
                                      N * groups * 2)]
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    ws, part, stats = scratch.split(sizes)
    args = (x.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            out.data_ptr(), ws.data_ptr(), part.data_ptr(), stats.data_ptr(),
            N, H, W, Cin, Cout, groups, float(eps), is_bf16)
    with on_device(dev):
        err = lib.conv_gn_relu_forward(*args, raw_stream(dev))
    check_launch('conv_gn_relu', err)
    launches += 1
    return out
