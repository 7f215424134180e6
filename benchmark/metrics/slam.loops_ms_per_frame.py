"""slam.loops_ms_per_frame: ms per frame of the host-clock span around
the engine's _window_loops (scan-context retrieval and GICP
verification, models/scan_context.py, models/loop_closure.py), in the session run with no profiler (unsynchronised: see
drivers/slam_session.py)."""

from benchmark.metrics import _common


def read(ctx):
    return _common.span_ms_per_frame(ctx, "loops")
