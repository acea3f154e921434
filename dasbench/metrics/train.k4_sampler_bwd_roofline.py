"""train.k4_sampler_bwd_roofline: the sampler backward's share of its
roofline in training steps, %: the least time of the profiled steps'
sample backwards (``dasbench.roofline.k4_sampler_backward``) over the
device time of each library call: ``sample_bwd_direct_kernel`` with the
memset before it and the cast to bf16 after it."""

from dasbench.roofline.k4_sampler_backward import step_bound_ms
from dasbench.trace import call_s


def read(record):
    tr = record['trace']
    t = call_s(tr, 'sample_bwd_direct_kernel', 'emset', 'cast_bf16_kernel')
    if not record['launches_ok'] or t <= 0:
        return None
    bound = step_bound_ms(record['config']['model'], record['batch'],
                          record['hw'], record['max_pos']) \
        * tr['units'] / 1e3
    return 100.0 * bound / t
