"""removal.patchwork_ms_per_frame: ms per frame of the synchronised span
around patchwork.estimate_ground (models/patchwork.py)."""

from benchmark.metrics import _common


def read(ctx):
    return _common.span_ms_per_frame(ctx, "patchwork")
