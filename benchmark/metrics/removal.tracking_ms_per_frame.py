"""removal.tracking_ms_per_frame: ms per frame of the synchronised span
around tracking.track_window (models/tracking.py; launch-bound, so the
wall time is what counts)."""

from benchmark.metrics import _common


def read(ctx):
    return _common.span_ms_per_frame(ctx, "tracking")
