"""The shifted-window attention of a Swin backbone (the port's
``csrc/window_attn.cu``, ``window_attn_kernel``): the (window, head) pairs
of one served request and their least time.

A block's attention pads its stage's map to whole windows of ``w x w``
tokens (``window_size``; the stage maps are the image over ``patch_size``,
then halved by each merging, rounded up) and attends within each window,
each head apart. A pair reads q, k and v (N = w^2 tokens of d = C / heads
channels each, bf16) and writes o: 4 N d elements of 2 bytes; it computes
q k^T and p v, 4 N^2 d operations (a multiply and an add each). A layer
also reads its bias table once, (2w - 1)^2 x heads f32: the relative-
position bias is gathered from it, whatever kernel does the gather. The
softmax's exponentials and the mask are not counted.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from . import PEAK_BF16_FLOPS, bound_ms


def _up(a: int, b: int) -> int:
    return -(-a // b)


def layers(backbone: Dict, batch: int, hw
           ) -> List[Tuple[int, int, int, int]]:
    """(pairs, tokens a window, head dimension, heads) of each block's
    attention in one forward of ``batch`` images at ``hw``."""
    ws, p = backbone['window_size'], backbone['patch_size']
    h, w = _up(int(hw[0]), p), _up(int(hw[1]), p)
    dims = backbone['embed_dims']
    out = []
    for depth, heads in zip(backbone['depths'], backbone['num_heads']):
        windows = batch * _up(h, ws) * _up(w, ws)
        out += [(windows * heads, ws * ws, dims // heads, heads)] * depth
        h, w, dims = _up(h, 2), _up(w, 2), 2 * dims
    return out


def pairs(backbone: Dict, batch: int, hw) -> int:
    """(window, head) pairs a forward."""
    return sum(layer[0] for layer in layers(backbone, batch, hw))


def layer_work(n: int, N: int, d: int, heads: int, window: int
               ) -> Tuple[float, float]:
    """(operations, bytes) of one layer's window attention: ``n`` pairs of
    ``N`` tokens and ``d`` channels, ``heads`` heads of a ``window``."""
    return (4.0 * n * N * N * d,
            4.0 * n * N * d * 2 + (2 * window - 1) ** 2 * heads * 4)


def request_work(backbone: Dict, batch: int, hw) -> Tuple[float, float]:
    """(operations, bytes) of one forward's window attention."""
    flops = nbytes = 0.0
    for layer in layers(backbone, batch, hw):
        f, b = layer_work(*layer, backbone['window_size'])
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes


def request_bound_ms(backbone: Dict, batch: int, hw) -> float:
    """The least time of one forward's window attention on an H100, bf16:
    the larger of its operations at 989 TFLOP/s and its bytes at
    3.35 TB/s."""
    flops, nbytes = request_work(backbone, batch, hw)
    return bound_ms(flops, PEAK_BF16_FLOPS, nbytes)[0]
