"""Image sampling and resizing (NHWC), port of ``das_tpu/ops/interp.py``.

* ``sample_bilinear_abs``     — bilinear sampling at absolute pixel
  coordinates with zero padding (the deformable conv, the recursive-update
  re-sampling). The JAX package's ``clip``/``fill``/``one_hot``/``patch``/
  ``xpack`` modes are TPU lowerings of this one function with bit-equal
  results; the port has one.
* ``interpolate_bilinear_ac`` — torch ``F.interpolate(align_corners=True)``.
* ``upsample_nearest``        — mmdet FPN top-down ``mode='nearest'``.

The public functions take NHWC tensors. The resizes only index along the
named axes, so an NCHW tensor permuted to NHWC works without a copy; the
sampler gathers rows of the contiguous (N, H*W, C) image, which a
channels_last map permuted to NHWC already is.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .gather import sample_rows_bilinear


def sample_bilinear_abs(img: torch.Tensor, x: torch.Tensor,
                        y: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bilinear sample ``img`` (N,H,W,C) at absolute pixel coords.

    ``x``/``y`` have shape (N, ...). Out-of-bounds corners contribute zero
    (torch ``padding_mode='zeros'``). Coordinates are f32 whatever the image
    type: in bf16 a coordinate >= 128 has no fractional part left. Corner
    weights are computed in f32 and cast to ``img.dtype`` before they
    multiply, and the four corners are summed in ``img.dtype`` in the order
    (x0,y0), (x1,y0), (x0,y1), (x1,y1), as the JAX function does. The whole
    sample is one launch of K4's fused sampler (``ops/gather.py``) on the
    card, and where autograd records it its backward is one launch too; on
    the CPU the plain composition of one row gather of all four corners of
    the flat (N, H*W, C) image, as the JAX function's ``'clip'`` row
    gathers, with the weights around it, and its closed-form backward.
    ``mask`` (x's shape, ``img.dtype``), where autograd does not record:
    each point's sample times its value, in the same launch.

    Returns (N, *x.shape[1:], C).
    """
    N, H, W, C = img.shape
    flat = img.reshape(N, H * W, C).contiguous()
    out = sample_rows_bilinear(
        flat, x.reshape(N, -1).float(), y.reshape(N, -1).float(), H, W,
        None if mask is None else mask.reshape(N, -1))
    return out.reshape(*x.shape, C)


@functools.lru_cache(maxsize=64)
def _interp_taps_ac(src: int, dst: int):
    """(lo, hi, w_hi) static taps for align_corners=True resizing."""
    if dst == 1:
        return (np.zeros(1, np.int64), np.zeros(1, np.int64),
                np.zeros(1, np.float32))
    scale = (src - 1) / (dst - 1)
    pos = np.arange(dst) * scale
    lo = np.clip(np.floor(pos).astype(np.int64), 0, src - 1)
    hi = np.clip(lo + 1, 0, src - 1)
    w_hi = (pos - lo).astype(np.float32)
    return lo, hi, w_hi


def interpolate_bilinear_ac(x: torch.Tensor, out_h: int, out_w: int
                            ) -> torch.Tensor:
    """Bilinear resize, align_corners=True, NHWC: a 2-tap lerp per axis,
    ``lo + (hi - lo) * w`` in ``x.dtype``, height first."""
    N, H, W, C = x.shape
    if (H, W) == (out_h, out_w):
        return x

    def lerp_axis(x, axis, src, dst):
        lo, hi, w_hi = _interp_taps_ac(src, dst)
        shape = [1, 1, 1, 1]
        shape[axis] = dst
        w = torch.from_numpy(w_hi).to(x.device).to(x.dtype).reshape(shape)
        xlo = x.index_select(axis, torch.from_numpy(lo).to(x.device))
        xhi = x.index_select(axis, torch.from_numpy(hi).to(x.device))
        return xlo + (xhi - xlo) * w

    if H != out_h:
        x = lerp_axis(x, 1, H, out_h)
    if W != out_w:
        x = lerp_axis(x, 2, W, out_w)
    return x


def upsample_nearest(x: torch.Tensor, out_h: int, out_w: int
                     ) -> torch.Tensor:
    """Nearest resize to (out_h, out_w), NHWC; torch
    ``F.interpolate(mode='nearest')`` (src = floor(dst * in / out))."""
    N, H, W, C = x.shape
    if (H, W) == (out_h, out_w):
        return x
    if out_h % H == 0 and out_w % W == 0:
        x = x.repeat_interleave(out_h // H, dim=1)
        return x.repeat_interleave(out_w // W, dim=2)
    iy = torch.from_numpy(np.arange(out_h) * H // out_h).to(x.device)
    ix = torch.from_numpy(np.arange(out_w) * W // out_w).to(x.device)
    return x.index_select(1, iy).index_select(2, ix)
