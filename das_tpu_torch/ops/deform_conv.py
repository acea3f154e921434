"""Modulated deformable convolution (DCNv2), port of
``das_tpu/ops/deform_conv.py``.

Semantics match mmcv's pack layer: ``conv_offset`` gives 3*K*K channels,
the first 2*K*K are (dy, dx) interleaved per tap (row-major), the last K*K
are mask logits passed through a sigmoid; sampling pads with zeros.

``gather_mode`` takes the config's names as they are:

* ``'patch'`` (and the bit-equal ``'clip'``, ``'fill'``, ``'one_hot'``,
  ``'xpack'``) — the exact bilinear gather;
* ``'shift_pallas'`` — the hand kernel ``dcn_shift.deform_conv_shift``,
  exact while every offset lies within ``shift_radius``;
* ``'hybrid_pallas'`` — the hand kernel plus ``_hybrid_repair``, the exact
  recompute of out-of-radius pixels: exact DCNv2 while each image has at
  most ``shift_budget`` such pixels;
* ``'shift'`` / ``'hybrid'`` — the same two with the plain shift expansion
  ``_deform_conv_shift`` as the base.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import dcn_shift
from .interp import sample_bilinear_abs

EXACT_MODES = ('patch', 'clip', 'fill', 'one_hot', 'xpack')
MODES = EXACT_MODES + ('shift', 'hybrid', 'shift_pallas', 'hybrid_pallas')


def modulated_deform_conv(x: torch.Tensor,
                          offset: torch.Tensor,
                          mask: torch.Tensor,
                          weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          kernel_size: int = 3,
                          padding: int = 1,
                          gather_mode: str = 'patch',
                          shift_radius: int = 2,
                          shift_budget: int = 2048) -> torch.Tensor:
    """DCNv2 forward, stride 1, dilation 1, deform_groups 1, NHWC.

    Args:
        x:      (N, H, W, Cin)
        offset: (N, H, W, 2*K*K) — (dy, dx) interleaved per tap, row-major
        mask:   (N, H, W, K*K)   — already sigmoid-activated
        weight: (K, K, Cin, Cout)
        bias:   (Cout,) or None
    Returns:
        (N, H, W, Cout)
    """
    K = kernel_size
    if gather_mode == 'shift':
        return _deform_conv_shift(x, offset, mask, weight, bias, K, padding,
                                  shift_radius)
    if gather_mode == 'hybrid':
        base = _deform_conv_shift(x, offset, mask, weight, bias, K, padding,
                                  shift_radius)
        return _hybrid_repair(base, x, offset, mask, weight, bias, K,
                              padding, shift_radius, shift_budget)
    if gather_mode in ('shift_pallas', 'hybrid_pallas'):
        base = dcn_shift.deform_conv_shift(x, offset, mask, weight, bias,
                                           K=K, padding=padding,
                                           radius=shift_radius)
        if gather_mode == 'shift_pallas':
            return base
        return _hybrid_repair(base, x, offset, mask, weight, bias, K,
                              padding, shift_radius, shift_budget)
    if gather_mode not in EXACT_MODES:
        raise ValueError(f'unknown gather_mode {gather_mode!r}; '
                         f'expected one of {MODES}')

    N, H, W, Cin = x.shape
    Cout = weight.shape[-1]
    # coordinate math stays f32 in every dtype
    ys = torch.arange(H, dtype=torch.float32, device=x.device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=x.device)[None, None, :]
    out = torch.zeros((N, H, W, Cout), dtype=x.dtype, device=x.device) \
        if bias is None else \
        bias.to(x.dtype).expand(N, H, W, Cout)
    for k in range(K * K):
        kh, kw = divmod(k, K)
        sy = ys + (kh - padding) + offset[..., 2 * k].float()
        sx = xs + (kw - padding) + offset[..., 2 * k + 1].float()
        tap = sample_bilinear_abs(x, sx, sy) * mask[..., k:k + 1]
        out = out + tap @ weight[kh, kw]
    return out


def _deform_conv_shift(x: torch.Tensor, offset: torch.Tensor,
                       mask: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor], K: int, padding: int,
                       radius: int) -> torch.Tensor:
    """DCNv2 via dense shifted multiply-adds, the XLA shift semantics:
    offsets clamped to ``[-radius, radius]``, each tap's window sum and its
    contraction accumulated in ``x.dtype`` (the kernel accumulates the
    contractions in f32; the two agree in f32)."""
    N, H, W, Cin = x.shape
    Cout = weight.shape[-1]
    P = padding + radius + 1
    xp = torch.nn.functional.pad(x, (0, 0, P, P, P, P))
    out = torch.zeros((N, H, W, Cout), dtype=x.dtype, device=x.device) \
        if bias is None else \
        bias.to(x.dtype).expand(N, H, W, Cout)
    r = float(radius)
    for k in range(K * K):
        kh, kw = divmod(k, K)
        dy = offset[..., 2 * k].float().clamp(-r, r) + (kh - padding)
        dx = offset[..., 2 * k + 1].float().clamp(-r, r) + (kw - padding)
        acc = torch.zeros((N, H, W, Cin), dtype=x.dtype, device=x.device)
        for iy in range(kh - padding - radius, kh - padding + radius + 2):
            wy = (1.0 - (iy - dy).abs()).clamp_min(0.0)
            for ix in range(kw - padding - radius,
                            kw - padding + radius + 2):
                w = wy * (1.0 - (ix - dx).abs()).clamp_min(0.0)
                acc = acc + xp[:, iy + P:iy + P + H, ix + P:ix + P + W] \
                    * w.to(x.dtype)[..., None]
        acc = acc * mask[..., k:k + 1]
        out = out + acc @ weight[kh, kw]
    return out


def deform_offset_overflow(offset: torch.Tensor, radius: int,
                           budget: int) -> torch.Tensor:
    """Per-image count of pixels (beyond the hybrid budget) having any
    out-of-radius tap offset. The hybrid modes are exact DCNv2 iff this is
    0 for every image."""
    off = offset.float()
    N = off.shape[0]
    oor_px = (off.reshape(N, -1, off.shape[-1] // 2, 2).abs()
              > radius).any(-1).any(-1)
    return (oor_px.sum(-1) - budget).clamp_min(0)


def _hybrid_repair(base, x, offset, mask, weight, bias, K, padding,
                   radius, budget):
    """Exact repair of out-of-radius pixels on any shift base.

    The ``budget`` worst pixels per image (by how far their worst tap lies
    outside the radius box) are recomputed with the exact gather, in the
    same tap order and accumulation as ``'patch'``, and set into the
    output. The repair runs only when some pixel is flagged; the test is a
    Python ``if``, so it costs one host sync per call.
    """
    N, H, W, Cin = x.shape
    Cout = weight.shape[-1]
    KK = K * K
    HW = H * W
    M = min(budget, HW)
    r = float(radius)

    off = offset.float().reshape(N, HW, KK, 2)
    # per-pixel violation score: worst tap's distance outside the box
    score = off.abs().amax(dim=(-1, -2)) - r                 # (N, HW)
    if not bool((score > 0).any()):
        return base

    top, p = torch.topk(score, M, dim=1)                     # (N, M)
    valid = top > 0
    nidx = torch.arange(N, device=x.device)[:, None]
    py = torch.div(p, W, rounding_mode='floor').float()
    px = (p % W).float()
    d = off[nidx, p]                                         # (N, M, KK, 2)
    m_sel = mask.reshape(N, HW, KK)[nidx, p]                 # (N, M, KK)

    exact = torch.zeros((N, M, Cout), dtype=x.dtype, device=x.device) \
        if bias is None else bias.to(x.dtype).expand(N, M, Cout)
    for t in range(KK):
        kh, kw = divmod(t, K)
        sy = py + (kh - padding) + d[..., t, 0]
        sx = px + (kw - padding) + d[..., t, 1]
        tap = sample_bilinear_abs(x, sx, sy) * m_sel[..., t:t + 1].to(x.dtype)
        exact = exact + tap @ weight[kh, kw]

    flat = base.reshape(N, HW, Cout).clone()
    flat[nidx, p] = torch.where(valid[..., None], exact, flat[nidx, p])
    return flat.reshape(base.shape)
