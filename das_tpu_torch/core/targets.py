"""Grid points of the head's levels, port of ``make_points`` in
``das_tpu/core/targets.py`` (target assignment belongs to training and
waits)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def make_points(featmap_sizes: Sequence[Tuple[int, int]],
                strides: Sequence[int]) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """All-level points, their strides and per-point level id.

    Points follow the reference convention ``grid * stride + stride // 2``
    (ref das_head.py:269-279).
    """
    pts, strd, lvl = [], [], []
    for i, ((h, w), s) in enumerate(zip(featmap_sizes, strides)):
        ys, xs = np.mgrid[0:h, 0:w]
        p = np.stack([xs.reshape(-1) * s, ys.reshape(-1) * s], -1) + s // 2
        pts.append(p.astype(np.float32))
        strd.append(np.full(h * w, s, np.float32))
        lvl.append(np.full(h * w, i, np.int32))
    return (np.concatenate(pts), np.concatenate(strd), np.concatenate(lvl))
