"""train_mfu: the training steps' share of the chip's bf16 peak, %: the
forward and backward FLOPs of a step (``dasbench.roofline.model_flops``;
remat's recompute is not counted) times the steps of the traced window,
over its seconds times 989 TFLOP/s."""

from dasbench.roofline import PEAK_BF16_FLOPS
from dasbench.roofline.model_flops import flops


def read(record):
    w = record['window']
    f = flops(record['config']['model'], record['batch'], record['hw'],
              train=True)
    return 100.0 * f * w['units'] / (w['seconds'] * PEAK_BF16_FLOPS)
