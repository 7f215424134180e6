"""datadir.device_idle_pct: the share of the wall time of a slam_datadir
session, run with no profiler, in which no kernel, copy or fill ran on the
card: the device time of the profiled session over the same files
(_common.idle_pct, the reduction of slam.device_idle_pct)."""

from benchmark.metrics import _common


def read(ctx):
    return _common.idle_pct(ctx)
