"""K4's sampler backward (``csrc/gather_rows.cu``: a memset of the f32
image gradient, ``sample_bwd_direct_kernel``, the cast to bf16): every
sample that a training step records.

Its bytes: the output gradient (N, P, C) and the image read once, the
coordinates read, the image gradient written once in its type and the
two coordinate gradients in f32. Its operations: two f32 a channel for
each in-bounds corner of non-zero weight (its share of the image
gradient) and two for each in-bounds corner (its share of the corner
weights' gradient); at most 16 a channel a point, which at these shapes
stays below the bytes' time (asserted in ``dasbench/tests``), so the
bound is the bytes' whatever the offsets.
"""

from __future__ import annotations

from typing import Dict, Tuple

from . import PEAK_F32_FLOPS, bound_ms
from .k4_sampler import calls


def backward_bound_ms(N: int, R: int, P: int, C: int, elt: int,
                      ops_per_channel_point: float = 16.0
                      ) -> Tuple[float, str]:
    nbytes = (N * P * C + 2 * N * R * C) * elt + 16 * N * P
    return bound_ms(ops_per_channel_point * C * N * P, PEAK_F32_FLOPS, nbytes)


def step_bound_ms(model: Dict, batch: int, hw, max_pos: int) -> float:
    """The least time of one step's sample backwards, bf16: one a sample
    of the forward (a rematerialised region's recompute adds samples,
    not backwards)."""
    return sum(backward_bound_ms(*c, 2)[0]
               for c in calls(model, batch, hw, max_pos))
