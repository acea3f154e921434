"""serve.neck_ms: the mean device time a served request spends in
the FPN neck (CUDA events from forward hooks on ``model.neck``), in ms."""

from dasbench.trace import mean_span_ms


def read(record):
    return mean_span_ms(record, 'neck')
