"""Test-time preprocessing on the device, port of
``das_tpu/ops/preprocess.py``.

The reference preprocesses on the host (cv2 resize + normalize + pad inside
dataloader workers). Here the chain — uint8 decode output -> keep-ratio
bilinear resize -> BGR->RGB -> normalize -> pad — runs on the model's
device, so only the raw uint8 image crosses PCIe.

The bilinear resize samples at half-pixel centres (cv2.INTER_LINEAR's
convention) with the taps and weights of the JAX package's
``_interp_matrix_halfpixel``, computed as two separable two-tap lerps in
f32. The JAX function multiplies by the (dst, src) matrices at
``Precision.HIGHEST``; a matmul here would run in TF32 wherever a caller
enabled it, and the lerps give the same result whatever the global flags.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .interp import sample_bilinear_abs


@functools.lru_cache(maxsize=64)
def _taps_halfpixel(src: int, dst: int):
    """(lo, hi, w_lo, w_hi) of each output position: the two non-zero
    entries of row ``o`` of the JAX package's (dst, src) interpolation
    matrix. Where both taps clip to one source index, its weight is the
    matrix entry ``(1 - w) + w`` (f32) and the second tap weighs 0."""
    scale = src / dst
    pos = (np.arange(dst) + 0.5) * scale - 0.5
    lo = np.floor(pos).astype(np.int64)
    w_hi = (pos - lo).astype(np.float32)
    w_lo = np.float32(1.0) - w_hi
    lo_c = np.clip(lo, 0, src - 1)
    hi_c = np.clip(lo + 1, 0, src - 1)
    same = lo_c == hi_c
    w_lo = np.where(same, w_lo + w_hi, w_lo).astype(np.float32)
    w_hi = np.where(same, np.float32(0.0), w_hi).astype(np.float32)
    return lo_c, hi_c, w_lo, w_hi


def _lerp_axis(x: torch.Tensor, axis: int, dst: int) -> torch.Tensor:
    lo, hi, w_lo, w_hi = _taps_halfpixel(x.shape[axis], dst)
    shape = [1] * x.dim()
    shape[axis] = dst
    dev = x.device
    a = x.index_select(axis, torch.from_numpy(lo).to(dev))
    b = x.index_select(axis, torch.from_numpy(hi).to(dev))
    return a * torch.from_numpy(w_lo).to(dev).reshape(shape) \
        + b * torch.from_numpy(w_hi).to(dev).reshape(shape)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int
                    ) -> torch.Tensor:
    """Half-pixel bilinear resize of an f32 NHWC tensor: height first,
    then width, as the JAX function's two products."""
    N, H, W, C = x.shape
    if (H, W) == (out_h, out_w):
        return x
    return _lerp_axis(_lerp_axis(x, 1, out_h), 2, out_w)


def make_preprocess_fn(in_hw: Tuple[int, int],
                       resized_hw: Tuple[int, int],
                       pad_hw: Tuple[int, int],
                       mean=(123.675, 116.28, 103.53),
                       std=(58.395, 57.12, 57.375),
                       to_rgb: bool = True):
    """Build fn: uint8 BGR (N,H,W,3) on the device -> normalized, padded
    f32 (N, *pad_hw, 3) on the same device.

    ``resized_hw`` is the keep-ratio target; ``pad_hw`` the /32 bucket.
    """
    mean_np = np.asarray(mean, np.float32)
    std_np = np.asarray(std, np.float32)

    def preprocess(raw: torch.Tensor) -> torch.Tensor:
        if tuple(raw.shape[1:3]) != tuple(in_hw):
            raise ValueError(f'images of {tuple(raw.shape[1:3])}, the fn '
                             f'was built for {tuple(in_hw)}')
        x = resize_bilinear(raw.float(), *resized_hw)
        if to_rgb:
            x = x.flip(-1)
        x = (x - torch.from_numpy(mean_np).to(x.device)) \
            / torch.from_numpy(std_np).to(x.device)
        pad_h = pad_hw[0] - resized_hw[0]
        pad_w = pad_hw[1] - resized_hw[1]
        return torch.nn.functional.pad(x, (0, 0, 0, pad_w, 0, pad_h))

    return preprocess


def affine_warp(img: torch.Tensor, trans: torch.Tensor, out_h: int,
                out_w: int, border_value) -> torch.Tensor:
    """Inverse-mapped affine warp on the device (cv2.warpAffine semantics,
    ref transforms_3d.py:986) for device-side train augmentation.

    Args:
        img: (N, H, W, C) float
        trans: (N, 2, 3) forward affine (dst <- src mapping is inverted
               here, matching cv2's behaviour for non-INVERSE_MAP flags)
        border_value: (C,) fill value outside the source image
    """
    N = img.shape[0]
    trans = torch.as_tensor(trans, dtype=torch.float32, device=img.device)
    a = trans[:, :, :2]                                     # (N,2,2)
    b = trans[:, :, 2]                                      # (N,2)
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    inv = torch.stack([
        torch.stack([a[:, 1, 1], -a[:, 0, 1]], -1),
        torch.stack([-a[:, 1, 0], a[:, 0, 0]], -1)], 1) / det[:, None, None]

    dev = img.device
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
    dx = xs.expand(N, out_h, out_w) - b[:, 0, None, None]
    dy = ys.expand(N, out_h, out_w) - b[:, 1, None, None]
    src_x = inv[:, 0, 0, None, None] * dx + inv[:, 0, 1, None, None] * dy
    src_y = inv[:, 1, 0, None, None] * dx + inv[:, 1, 1, None, None] * dy

    # constant-border bilinear == zeros-padded sampling of (img - border)
    # plus border: out-of-bounds taps contribute exactly the border colour
    border = torch.as_tensor(np.asarray(border_value), dtype=img.dtype,
                             device=dev)
    return sample_bilinear_abs(img - border, src_x, src_y) + border
