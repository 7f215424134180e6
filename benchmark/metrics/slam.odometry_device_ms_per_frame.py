"""slam.odometry_device_ms_per_frame: device ms per frame of the kernels
launched inside the engine's program span "odometry" (scan-to-map GICP,
models/gicp.py) in a profiled SLAM session (program_record.profiled):
those whose start, less the trace's clock offset, lies inside such a span
(program_record.device_ms_in_spans). Nothing without the marker's offset."""

from benchmark import program_record


def read(ctx):
    return program_record.device_ms_in_spans(ctx, "odometry")
