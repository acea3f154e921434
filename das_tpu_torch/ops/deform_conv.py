"""Modulated deformable convolution (DCNv2), port of
``das_tpu/ops/deform_conv.py``.

Semantics match mmcv's pack layer: ``conv_offset`` gives 3*K*K channels,
the first 2*K*K are (dy, dx) interleaved per tap (row-major), the last K*K
are mask logits passed through a sigmoid; sampling pads with zeros.

``gather_mode`` takes the config's names as they are:

* ``'patch'`` (and the bit-equal ``'clip'``, ``'fill'``, ``'one_hot'``,
  ``'xpack'``) — the exact bilinear gather. Where autograd records (the
  training lowering ``'clip'``), the nine taps are sampled in one sample,
  then each is multiplied by its mask, contracted and added in
  ``x.dtype`` (``_deform_conv_per_tap``, JAX's order and roundings).
  Where it does not (serving), one masked sample writes the (N*H*W,
  K*K*Cin) im2col matrix and one matmul contracts all taps, summing in
  f32 and rounding once (``_deform_conv_im2col``); in f32 the two agree
  to rounding, in bf16 the matmul is the more precise;
* ``'shift_pallas'`` — the hand kernel ``dcn_shift.deform_conv_shift``,
  exact while every offset lies within ``shift_radius``;
* ``'hybrid_pallas'`` — the hand kernel plus ``_hybrid_repair``, the exact
  recompute of out-of-radius pixels: exact DCNv2 while each image has at
  most ``shift_budget`` such pixels;
* ``'shift'`` / ``'hybrid'`` — the same two on the card (the lowerings
  training takes: K1 forward and, under autograd, K1's backward); on the
  CPU with the plain shift expansion ``_deform_conv_shift`` as the base.
  The two compute one function; in bf16 the kernel sums the nine tap
  contractions in f32 where ``_deform_conv_shift`` rounds each to bf16.
"""

from __future__ import annotations

import functools
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
    if gather_mode in ('shift', 'hybrid', 'shift_pallas', 'hybrid_pallas'):
        if gather_mode in ('shift', 'hybrid') and x.device.type == 'cpu':
            base = _deform_conv_shift(x, offset, mask, weight, bias, K,
                                      padding, shift_radius)
        else:
            base = dcn_shift.deform_conv_shift(x, offset, mask, weight, bias,
                                               K=K, padding=padding,
                                               radius=shift_radius)
        if gather_mode in ('shift', 'shift_pallas'):
            return base
        return _hybrid_repair(base, x, offset, mask, weight, bias, K,
                              padding, shift_radius, shift_budget)
    if gather_mode not in EXACT_MODES:
        raise ValueError(f'unknown gather_mode {gather_mode!r}; '
                         f'expected one of {MODES}')
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, offset, mask, weight, bias)):
        return _deform_conv_per_tap(x, offset, mask, weight, bias, K,
                                    padding)
    return _deform_conv_im2col(x, offset, mask, weight, bias, K, padding)


def _deform_conv_per_tap(x: torch.Tensor, offset: torch.Tensor,
                         mask: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor], K: int,
                         padding: int) -> torch.Tensor:
    """The exact DCN under autograd: the nine taps in one sample, taps
    outermost, then per tap the mask product, the contraction and the sum,
    each rounded to ``x.dtype``."""
    N, H, W, Cin = x.shape
    Cout = weight.shape[-1]
    # coordinate math stays f32 in every dtype
    ys = torch.arange(H, dtype=torch.float32, device=x.device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=x.device)[None, None, :]
    out = torch.zeros((N, H, W, Cout), dtype=x.dtype, device=x.device) \
        if bias is None else \
        bias.to(x.dtype).expand(N, H, W, Cout)
    # all K*K taps in one sample, taps outermost: (N, K*K, H, W) points
    sy = ys[:, None] + _tap_shift(K, padding, 0, x.device)[:, None, None] \
        + offset[..., 0::2].float().permute(0, 3, 1, 2)
    sx = xs[:, None] + _tap_shift(K, padding, 1, x.device)[:, None, None] \
        + offset[..., 1::2].float().permute(0, 3, 1, 2)
    taps = sample_bilinear_abs(x, sx.reshape(N, -1), sy.reshape(N, -1)) \
        .reshape(N, K * K, H, W, Cin)
    for k in range(K * K):
        kh, kw = divmod(k, K)
        tap = taps[:, k] * mask[..., k:k + 1]
        out = out + tap @ weight[kh, kw]
    return out


def _deform_conv_im2col(x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor], K: int,
                        padding: int) -> torch.Tensor:
    """The exact DCN where autograd does not record: the points in the
    offsets' own order, pixel-major and tap-minor, one masked sample (the
    sample times the mask, rounded as ``_deform_conv_per_tap`` rounds that
    product), which is the (N*H*W, K*K*Cin) im2col matrix, and one matmul
    with the (K*K*Cin, Cout) kernel that adds the bias."""
    N, H, W, Cin = x.shape
    Cout = weight.shape[-1]
    ys = torch.arange(H, dtype=torch.float32, device=x.device)[:, None, None]
    xs = torch.arange(W, dtype=torch.float32, device=x.device)[:, None]
    # (N, H, W, K*K) points: the taps of a pixel innermost
    sy = ys + _tap_shift(K, padding, 0, x.device) + offset[..., 0::2].float()
    sx = xs + _tap_shift(K, padding, 1, x.device) + offset[..., 1::2].float()
    cols = sample_bilinear_abs(x, sx, sy, mask.to(x.dtype)) \
        .reshape(N * H * W, K * K * Cin)
    kernel = weight.reshape(K * K * Cin, Cout)
    out = cols @ kernel if bias is None else \
        torch.addmm(bias.to(x.dtype), cols, kernel)
    return out.reshape(N, H, W, Cout)


@functools.lru_cache(maxsize=None)
def _tap_shift(K: int, padding: int, axis: int, device) -> torch.Tensor:
    """(K*K,) f32: each tap's row (``axis`` 0) or column (1) shift,
    ``kh - padding`` or ``kw - padding``, taps row-major. Kept for the
    process's life: a CUDA graph that captured a DCN reads it at its
    address."""
    return torch.tensor([float(divmod(k, K)[axis] - padding)
                         for k in range(K * K)], device=device)


def _deform_conv_shift(x: torch.Tensor, offset: torch.Tensor,
                       mask: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor], K: int, padding: int,
                       radius: int) -> torch.Tensor:
    """DCNv2 via dense shifted multiply-adds, the XLA shift semantics:
    offsets clamped to ``[-radius, radius]``, each tap's window sum and its
    contraction accumulated in ``x.dtype`` (the kernel accumulates the
    contractions in f32; the two agree in f32). Under autograd the offset's
    gradient is JAX's at the kinks too (``dcn_shift.hat``,
    ``dcn_shift.clamp_offset``): an integer offset, or one at +-radius, is
    where every training run from the zero-initialised ``conv_offset``
    starts."""
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
        dy = dcn_shift.clamp_offset(offset[..., 2 * k].float(), r) \
            + (kh - padding)
        dx = dcn_shift.clamp_offset(offset[..., 2 * k + 1].float(), r) \
            + (kw - padding)
        acc = torch.zeros((N, H, W, Cin), dtype=x.dtype, device=x.device)
        for iy in range(kh - padding - radius, kh - padding + radius + 2):
            wy = dcn_shift.hat(iy - dy)
            for ix in range(kw - padding - radius,
                            kw - padding + radius + 2):
                w = wy * dcn_shift.hat(ix - dx)
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
    # all K*K taps of the M pixels in one sample, taps outermost
    sy = py[:, None] + _tap_shift(K, padding, 0, x.device)[:, None] \
        + d[..., 0].permute(0, 2, 1)                         # (N, KK, M)
    sx = px[:, None] + _tap_shift(K, padding, 1, x.device)[:, None] \
        + d[..., 1].permute(0, 2, 1)
    taps = sample_bilinear_abs(x, sx.reshape(N, -1), sy.reshape(N, -1)) \
        .reshape(N, KK, M, Cin)
    for t in range(KK):
        kh, kw = divmod(t, K)
        tap = taps[:, t] * m_sel[..., t:t + 1].to(x.dtype)
        exact = exact + tap @ weight[kh, kw]

    flat = base.reshape(N, HW, Cout).clone()
    flat[nidx, p] = torch.where(valid[..., None], exact, flat[nidx, p])
    return flat.reshape(base.shape)
