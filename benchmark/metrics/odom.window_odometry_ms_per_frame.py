"""odom.window_odometry_ms_per_frame: ms per frame of the synchronised
program spans "window_odometry" around odometry.estimate_window_poses
(scan-to-scan GICP over a window's pairs, models/odometry.py) in the pass
of synchronised spans over the removal-odom pool
(program_record.span_ms_per_frame); nothing on a port without the span."""

from benchmark import program_record


def read(ctx):
    return program_record.span_ms_per_frame(ctx, "window_odometry")
