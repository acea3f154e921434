"""K3, the decode's OKS-NMS keep mask (``csrc/oks_nms.cu``:
``oks_mask_kernel`` and ``oks_scan_kernel``).

Its operations: 9 f32 a joint term (2 differences, 2 products, a sum, 2
divisions, an exponential, an accumulation) and 5 a pair (scale, mean,
compare) over each image's M(M-1)/2 pairs of score-sorted candidates;
a pair needs its joint terms only until even terms of 1 for every joint
left could not lift its mean over the threshold (the early exit), so the
terms are counted from the candidates themselves. Its bytes: kpts,
areas and valid read once, the keep mask written once.
"""

from __future__ import annotations

import torch

from . import PEAK_F32_FLOPS, bound_ms


def joint_terms(xy: torch.Tensor, areas: torch.Tensor, thr: float,
                var2: float, margin: float = 0.01) -> int:
    """The joint terms the pairs (i, j < i) of score-sorted candidates
    need: xy (B, M, J, 2), areas (B, M); var2 = 2 (2 sigma)^2."""
    B, M, J, _ = xy.shape
    left = torch.arange(J - 1, -1, -1, device=xy.device, dtype=torch.float32)
    need = thr * J - margin
    eps = float(torch.finfo(torch.float64).eps)
    terms = 0
    for b in range(B):
        for i0 in range(0, M, 256):
            rows = xy[b, i0:i0 + 256]
            d2 = ((rows[:, None] - xy[b][None]) ** 2).sum(-1)
            scale = (areas[b, i0:i0 + 256, None] + areas[b][None]) * 0.5 + eps
            cum = torch.exp(-d2 / var2 / scale[..., None]).cumsum(-1)
            stops = cum + left < need
            n = torch.where(stops.any(-1), stops.float().argmax(-1) + 1, J)
            below = torch.arange(M, device=xy.device)[None] < torch.arange(
                i0, i0 + rows.shape[0], device=xy.device)[:, None]
            terms += int((n * below).sum())
    return terms


def nms_bound_ms(B: int, M: int, J: int, terms: int) -> float:
    pairs = B * M * (M - 1) / 2.0
    return bound_ms(9.0 * terms + 5.0 * pairs, PEAK_F32_FLOPS,
                    B * M * (J * 2 * 4 + 4 + 1 + 1))[0]
