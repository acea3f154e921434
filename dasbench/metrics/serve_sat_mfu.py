"""serve_sat_mfu: the served requests' share of the chip's bf16 peak where
they go back to back (a mix above capacity), %: the model's FLOPs a
request (``dasbench.roofline.model_flops``) times the requests completed
in the window, over the window's seconds (host clock) times 989 TFLOP/s."""

from dasbench.roofline import PEAK_BF16_FLOPS
from dasbench.roofline.model_flops import flops


def read(record):
    w = record['window']
    f = flops(record['config']['model'], record['batch'], record['hw'],
              train=False)
    return 100.0 * f * w['units'] / (w['seconds'] * PEAK_BF16_FLOPS)
