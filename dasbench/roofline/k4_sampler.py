"""K4's fused bilinear sampler (``csrc/gather_rows.cu``,
``sample_rows_bilinear_kernel``): the samples of one served request.

A sample reads four corner rows a point (or the whole table once where
that is less: points share corners), two f32 coordinates a point, and
writes one row a point; 11 f32 operations a channel (4 products, 3 sums
and the weights' share). Per level a request samples its three towers'
DCNs (9 taps a pixel of the 256-channel map), and in each RU layer its
DCN, the proposal field at the joints' targets (8 channels) and the
[uvd, conf] field at the 2 x heads candidates (6 channels); the last RU
layer re-samples only the decode's ``nms_pre`` candidates where a level
has more points.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from . import PEAK_F32_FLOPS, bound_ms, level_sizes


def sampler_bound_ms(N: int, R: int, P: int, C: int, elt: int
                     ) -> Tuple[float, str]:
    return bound_ms(11.0 * N * P * C, PEAK_F32_FLOPS,
                    (min(4 * P, R) + P) * N * C * elt + 8 * N * P)


def calls(model: Dict, batch: int, hw, keep: int) -> List[Tuple]:
    """(N, R, P, C) of every sample of one forward at image size ``hw``;
    ``keep`` points a level re-sampled by the last RU layer (the decode's
    nms_pre when serving, the positives' budget in training), or None
    for all."""
    J, ru = model['num_joints'], model['ru']
    heads, D, C = ru['num_heads'], ru['dim'], model['feat_channels']
    out = []
    for h, w in level_sizes(*hw, len(model['strides'])):
        R = h * w
        out += [(batch, R, 9 * R, C)] * 3
        for i in range(ru['num_layers']):
            out.append((batch, R, 9 * R, C))
            last = i == ru['num_layers'] - 1
            P = keep if last and keep is not None and R > keep else R
            out.append((batch * J, R, P, heads * 2))
            out.append((batch * J, R, P * 2 * heads, 2 * D))
    return out


def request_bound_ms(model: Dict, batch: int, hw) -> float:
    """The least time of one served request's samples, bf16."""
    keep = int(model['test_cfg']['nms_pre'])
    return sum(sampler_bound_ms(*c, 2)[0]
               for c in calls(model, batch, hw, keep))
