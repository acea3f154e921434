"""serve.to_host_ms: the mean device time a served request spends in
``results_to_host`` (the host clock around it), in ms."""

from dasbench.trace import mean_span_ms


def read(record):
    return mean_span_ms(record, 'to_host')
