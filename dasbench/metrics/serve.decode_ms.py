"""serve.decode_ms: the mean device time a served request spends in
the decode (CUDA events from the head's end to the predict call's
return), in ms."""

from dasbench.trace import mean_span_ms


def read(record):
    return mean_span_ms(record, 'decode')
