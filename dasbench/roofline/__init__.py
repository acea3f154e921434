"""The chip's peaks and the least time of a piece of work.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
card's full 700 W): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32
outside them, 3.35 TB/s of HBM3. A kernel's roofline share is the least
time of its work, the larger of operations over the peak rate and bytes
over the peak bandwidth, divided by its measured device time. Each
module here counts one kernel's operations and bytes from the shapes of
a configuration, whatever kernel implements the work.
"""

from __future__ import annotations

from typing import Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_ms(flops: float, peak_flops: float, nbytes: float
             ) -> Tuple[float, str]:
    """(ms, 'operations' or 'bytes'): the larger of the two least times."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        'operations' if t_ops >= t_bytes else 'bytes'


def level_sizes(h: int, w: int, n: int = 4):
    """The (H, W) of the head's n feature maps, at strides 4 to 32 of the
    (padded) image."""
    return [(h // (4 * 2 ** i), w // (4 * 2 ** i)) for i in range(n)]
