"""serve.preprocess_ms: the mean device time a served request spends in
preprocessing (CUDA events around ``make_preprocess_fn``'s call), in ms."""

from dasbench.trace import mean_span_ms


def read(record):
    return mean_span_ms(record, 'preprocess')
