"""Shifted-window multi-head self-attention of a Swin block (CUDA, sm_90a),
and its plain version.

Replaces no TPU kernel: the JAX package has no Swin. ``window_attention``
computes mmdet's ``WindowMSA`` between its two projections, for the
windows of a layer at once:

    attn = softmax((q * scale) @ k^T + bias + mask) @ v

per (window, head) pair, with q, k and v read from the qkv projection of
the windows' tokens, ``bias[h, i, j] = table[index[i, j], h]`` the
relative-position bias and, for a shifted layer, ``mask`` -100 between
tokens of different regions of the rolled map (``shift_mask``), 0
elsewhere.

On a CUDA tensor the wrapper launches the hand-written kernel
(``das_tpu_torch/csrc/window_attn.cu``: one pass, the logits in registers),
which takes bf16 windows of 12 x 12 tokens and heads of 32 channels, or
raises; it has no backward and raises where autograd would record it. On a
CPU tensor it runs the plain version, ``window_attention_plain`` (mmdet's
chain of PyTorch calls), which is also the route under autograd: callers
choose it there (``SwinTransformer``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .bn_act import records
from .cuda_build import (FLOAT, INT, LONG, PTR, CudaLibrary, check_launch,
                         on_device, raw_stream)

LIB = CudaLibrary('window_attn.cu', {
    'window_attn_forward': [PTR, PTR, PTR, LONG, INT, INT, INT, INT, FLOAT,
                            PTR]})

WINDOW = 12        # the kernel's window side (144 tokens)
HEAD_DIM = 32      # and head dimension
MASK = -100.0      # mmdet's value between regions of a shifted layer

# Kernel launches and (window, head) pairs since the last reset; the main
# path's run reads them.
launches = 0
pairs = 0


def relative_position_index(window: int) -> torch.Tensor:
    """(N, N) int64, N = window ** 2: the row of the bias table for each
    pair of a window's tokens, mmdet's ``double_step_seq`` construction
    (``(yi - yj + w - 1) * (2w - 1) + (xi - xj + w - 1)``)."""
    step = 2 * window - 1
    seq = (torch.arange(0, step * window, step)[:, None]
           + torch.arange(window)[None, :]).reshape(1, -1)
    return (seq + seq.T).flip(1).contiguous()


def shift_mask(grid: Sequence[int], window: int, shift: int, device
               ) -> torch.Tensor:
    """(nW, N, N) f32: mmdet's attention mask of a shifted layer whose
    padded map holds ``grid`` = (nWh, nWw) windows: 0 between tokens of the
    same region of the rolled map, -100 between tokens of different ones.
    Regions: rows [0, Hp - window), [Hp - window, Hp - shift), [Hp - shift,
    Hp), the same for columns."""
    nwh, nww = grid
    hp, wp = nwh * window, nww * window

    def region(n):
        t = torch.arange(n, device=device)
        return (t >= n - window).long() + (t >= n - shift).long()
    label = region(hp)[:, None] * 3 + region(wp)[None, :]
    label = label.view(nwh, window, nww, window).permute(0, 2, 1, 3) \
        .reshape(nwh * nww, window * window)
    diff = label[:, None, :] != label[:, :, None]
    return torch.zeros(diff.shape, device=device).masked_fill_(diff, MASK)


def window_attention_plain(qkv: torch.Tensor, table: torch.Tensor,
                           index: torch.Tensor, heads: int,
                           grid: Sequence[int], shift: int) -> torch.Tensor:
    """mmdet's ``WindowMSA`` between its projections, as a chain of
    PyTorch calls: (q * scale) @ k^T in ``qkv``'s dtype, plus the bias and
    the mask (which promote to f32), softmax in f32, cast back, @ v. Shapes
    as ``window_attention``; any window and head size."""
    B_, N, C3 = qkv.shape
    C = C3 // 3
    d = C // heads
    q, k, v = qkv.reshape(B_, N, 3, heads, d).permute(2, 0, 3, 1, 4)
    attn = (q * d ** -0.5) @ k.transpose(-2, -1)
    bias = table[index.reshape(-1)].view(N, N, heads).permute(2, 0, 1)
    attn = attn + bias.unsqueeze(0)
    if shift:
        window = int(round(N ** 0.5))
        mask = shift_mask(grid, window, shift, qkv.device)
        nw = mask.shape[0]
        attn = (attn.view(B_ // nw, nw, heads, N, N)
                + mask.unsqueeze(1).unsqueeze(0)).view(B_, heads, N, N)
    attn = attn.softmax(-1).to(v.dtype)
    return (attn @ v).transpose(1, 2).reshape(B_, N, C)


def window_attention(qkv: torch.Tensor, table: torch.Tensor,
                     index: torch.Tensor, heads: int, grid: Sequence[int],
                     shift: int) -> torch.Tensor:
    """The windows' attention outputs, (B_, N, C) in ``qkv``'s dtype.

    Args: qkv (B_, N, 3C), the qkv projection of B_ windows of N tokens
    (the windows of an image row-major, ``grid`` = (nWh, nWw) of them, the
    tokens of a window row-major), C = heads * head dim; table (L, heads)
    f32, the layer's relative-position bias table; index (N, N) int64, its
    rows for each pair (``relative_position_index``); shift 0 or the
    cyclic shift of a shifted layer (the mask on).

    CPU tensors run ``window_attention_plain``; CUDA tensors launch the
    kernel, which takes contiguous bf16 ``qkv`` for 12 x 12 windows and
    32-channel heads, and a contiguous f32 ``table``."""
    global launches, pairs
    if records(qkv, table):
        raise RuntimeError('the window attention kernel has no backward: '
                           'take window_attention_plain where autograd '
                           'records')
    if qkv.device.type == 'cpu':
        return window_attention_plain(qkv, table, index, heads, grid, shift)
    if qkv.device.type != 'cuda':
        raise ValueError(f'no window attention kernel for device '
                         f'{qkv.device}')
    N = WINDOW * WINDOW
    if qkv.dim() != 3 or qkv.shape[1] != N or \
            qkv.shape[2] != 3 * heads * HEAD_DIM:
        raise ValueError(f'the kernel takes qkv (B_, {N}, 3 * heads * '
                         f'{HEAD_DIM}), got {tuple(qkv.shape)} with '
                         f'{heads} heads')
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous() or \
            qkv.data_ptr() % 16:
        raise ValueError('the kernel takes a contiguous, 16-byte aligned '
                         f'bf16 qkv (got {qkv.dtype})')
    dev = qkv.device
    if (table.dtype != torch.float32 or table.device != dev
            or tuple(table.shape) != ((2 * WINDOW - 1) ** 2, heads)
            or not table.is_contiguous()):
        raise ValueError(f'table must be ({(2 * WINDOW - 1) ** 2}, {heads}) '
                         f'f32 contiguous on {dev}, got {tuple(table.shape)} '
                         f'{table.dtype} on {table.device}')
    nwh, nww = int(grid[0]), int(grid[1])
    B_ = qkv.shape[0]
    if B_ % (nwh * nww) or shift not in (0, WINDOW // 2):
        raise ValueError(f'{B_} windows are not whole images of {nwh} x '
                         f'{nww}, or the shift {shift} is not 0 or '
                         f'{WINDOW // 2}')
    out = torch.empty(B_, N, heads * HEAD_DIM, dtype=qkv.dtype, device=dev)
    lib = LIB.load()
    with on_device(dev):
        err = lib.window_attn_forward(
            qkv.data_ptr(), table.data_ptr(), out.data_ptr(), B_, heads,
            nwh, nww, int(shift), float(HEAD_DIM ** -0.5), raw_stream(dev))
    check_launch('window_attn', err)
    launches += 1
    pairs += B_ * heads
    return out
