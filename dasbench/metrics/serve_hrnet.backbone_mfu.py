"""serve_hrnet.backbone_mfu: the backbone's share of the chip's bf16 peak
in served requests, %: its forward FLOPs at the cell's batch and bucket
(``dasbench.roofline.backbone_flops``) over ``serve_hrnet.backbone_ms``
(the backbone's mean device time a request, from forward hooks) times
989 TFLOP/s. None where no backbone time was recorded."""

from dasbench.roofline import PEAK_BF16_FLOPS
from dasbench.roofline.backbone_flops import flops
from dasbench.trace import mean_span_ms


def read(record):
    ms = mean_span_ms(record, 'backbone')
    if not ms:
        return None
    f = flops(record['config']['model']['backbone'], record['batch'],
              record['hw'])
    return 100.0 * f / (ms / 1e3 * PEAK_BF16_FLOPS)
