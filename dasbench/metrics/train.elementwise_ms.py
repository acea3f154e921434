"""train.elementwise_ms: the device time a training step spends in
PyTorch's elementwise kernels (mostly the 'clip' DCN's per-tap products
and sums in ``ops.deform_conv``), ms a step, from the profiler's trace by
kernel name."""

from dasbench.trace import kernel_s


def read(record):
    tr = record['trace']
    return 1e3 * kernel_s(tr, ('elementwise',)) / tr['units']
