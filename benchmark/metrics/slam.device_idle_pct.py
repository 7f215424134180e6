"""slam.device_idle_pct: the share of the wall time of the SLAM session,
run with no profiler, in which no kernel, copy or fill ran on the card: the
device time of the profiled pass over the same work (_common.idle_pct)."""

from benchmark.metrics import _common


def read(ctx):
    return _common.idle_pct(ctx)
