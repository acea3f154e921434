"""serve.k4_sampler_roofline: the fused bilinear sampler's share of its
roofline in served requests, %: the least time of the profiled requests'
samples (``dasbench.roofline.k4_sampler``) over the device time of
``sample_rows_bilinear_kernel``. None where the window's launches were
not the configuration's (the count of samples would be wrong)."""

from dasbench.roofline.k4_sampler import request_bound_ms
from dasbench.trace import kernel_s


def read(record):
    tr = record['trace']
    t = kernel_s(tr, ('sample_rows_bilinear_kernel',))
    if not record['launches_ok'] or t <= 0:
        return None
    bound = request_bound_ms(record['config']['model'], record['batch'],
                             record['hw']) * tr['units'] / 1e3
    return 100.0 * bound / t
