"""serve.head_ms: the mean device time a served request spends in
the head with its RU (CUDA events from forward hooks on
``model.bbox_head``), in ms."""

from dasbench.trace import mean_span_ms


def read(record):
    return mean_span_ms(record, 'head')
