"""odom.odometry_device_ms_per_frame: device ms per frame of the kernels
launched inside the program spans "window_odometry" (scan-to-scan GICP,
models/odometry.py and models/gicp.py) in a profiled pass over the
removal-odom pool (program_record.profiled): those whose start, less the
trace's clock offset, lies inside such a span
(program_record.device_ms_in_spans). Nothing without the marker's offset,
and no profiled pass where the pass of synchronised spans, which the
cell's other metrics read, opened no such span (a port or a cell without
the window odometry)."""

from benchmark import program_record

SPAN = "window_odometry"


def read(ctx):
    rec = program_record.synchronised(ctx)
    if rec is None or all(name != SPAN for name, *_ in rec.log):
        return None
    return program_record.device_ms_in_spans(ctx, SPAN)
