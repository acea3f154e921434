"""serve_sat.idle_share: as ``serve.idle_share``, in the cells above
capacity, where it moves the images completed: the share of the profiled
requests' wall time in which no operation ran on the device, %."""

from dasbench.trace import idle_pct


def read(record):
    return idle_pct(record) if record['kind'] == 'serve' else None
