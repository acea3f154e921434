"""serve_swin.window_attn_roofline: the fused shifted-window attention's
share of its roofline in served requests, %: the least time of the
profiled requests' window attention (``dasbench.roofline.
window_attention``: q, k, v and o of every (window, head) pair and each
layer's bias table, bytes-bound on an H100) over the device time of
``window_attn_kernel``. None where no such kernel ran."""

from dasbench.roofline.window_attention import request_bound_ms
from dasbench.trace import kernel_s


def read(record):
    tr = record['trace']
    t = kernel_s(tr, ('window_attn_kernel',))
    if t <= 0:
        return None
    bound = request_bound_ms(record['config']['model']['backbone'],
                             record['batch'], record['hw']) * tr['units'] / 1e3
    return 100.0 * bound / t
