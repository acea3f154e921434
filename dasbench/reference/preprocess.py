"""The reference's test-time preprocessing of camera frames: keep-ratio
bilinear resize with half-pixel centres (cv2.INTER_LINEAR's convention,
edge taps clamped), BGR to RGB, ImageNet mean and std, zero padding to
the bucket. Computed in float64 (the control: bfloat16)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .precision import current

MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)


def rescale_size(h: int, w: int, scale: Sequence[int]) -> Tuple[int, int]:
    """mmdet's keep-ratio size: fit within (max(scale), min(scale))."""
    f = min(max(scale) / max(h, w), min(scale) / min(h, w))
    return int(h * f + 0.5), int(w * f + 0.5)


def bucket(h: int, w: int, scale: Sequence[int]) -> Tuple[Tuple[int, int],
                                                          Tuple[int, int]]:
    """(resized (h, w), padded (h, w)): padded to multiples of 32."""
    nh, nw = rescale_size(h, w, scale)
    return (nh, nw), ((nh + 31) // 32 * 32, (nw + 31) // 32 * 32)


def _resize_axis(x: torch.Tensor, axis: int, dst: int) -> torch.Tensor:
    src = x.shape[axis]
    pos = (torch.arange(dst, dtype=torch.float64, device=x.device) + 0.5) \
        * (src / dst) - 0.5
    lo = torch.floor(pos)
    w = (pos - lo).to(x.dtype)
    lo = lo.long()
    a = x.index_select(axis, lo.clamp(0, src - 1))
    b = x.index_select(axis, (lo + 1).clamp(0, src - 1))
    shape = [1] * x.dim()
    shape[axis] = dst
    w = w.reshape(shape)
    return a * (1 - w) + b * w


def preprocess(frames: torch.Tensor, scale: Sequence[int]) -> torch.Tensor:
    """uint8 BGR frames (N, H, W, 3) -> normalised, padded RGB (N, PH, PW,
    3) in the stage's precision."""
    dt = current().preprocess
    (nh, nw), (ph, pw) = bucket(frames.shape[1], frames.shape[2], scale)
    x = frames.to(dt)
    x = _resize_axis(_resize_axis(x, 1, nh), 2, nw).flip(-1)
    mean = torch.tensor(MEAN, dtype=dt, device=x.device)
    std = torch.tensor(STD, dtype=dt, device=x.device)
    x = (x - mean) / std
    return torch.nn.functional.pad(x, (0, 0, 0, pw - nw, 0, ph - nh))
