"""serve_mfu: a served request's share of the chip's bf16 peak, %: the
model's FLOPs a request (``dasbench.roofline.model_flops``, one forward
of the reference at the cell's shapes) over the median service time of
the window's requests (host clock, from sent to answered, so without the
wait from when a request was due) times 989 TFLOP/s (the published peak
at 700 W; the card's power limit is printed beside each run)."""

from dasbench.roofline import PEAK_BF16_FLOPS
from dasbench.roofline.model_flops import flops


def read(record):
    f = flops(record['config']['model'], record['batch'], record['hw'],
              train=False)
    return 100.0 * f / (record['service_ms'] / 1e3 * PEAK_BF16_FLOPS)
