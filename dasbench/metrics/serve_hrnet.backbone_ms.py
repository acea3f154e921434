"""serve_hrnet.backbone_ms: the mean device time a served request spends
in the HRNet backbone (CUDA events from forward hooks on
``model.backbone``), in ms."""

from dasbench.trace import mean_span_ms


def read(record):
    return mean_span_ms(record, 'backbone')
