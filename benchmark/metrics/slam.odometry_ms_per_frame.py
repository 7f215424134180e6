"""slam.odometry_ms_per_frame: ms per frame of the host-clock span around
the engine's _window_odometry (scan-to-map GICP, models/gicp.py), in the session run with no profiler (unsynchronised: see
drivers/slam_session.py)."""

from benchmark.metrics import _common


def read(ctx):
    return _common.span_ms_per_frame(ctx, "odometry")
