"""train.idle_share: the share of the profiled steps' wall time in which
no operation ran on the device, %: 1 - (union of the device intervals
in the profiler's trace) / (the profiled window, which ends in a
synchronise)."""

from dasbench.trace import idle_pct


def read(record):
    return idle_pct(record) if record['kind'] == 'train' else None
