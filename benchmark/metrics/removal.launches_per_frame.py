"""removal.launches_per_frame: CUDA kernels per frame in the profiled
removal windows (the host dispatch of models/pipeline.py)."""

from benchmark.metrics import _common


def read(ctx):
    return _common.launches_per_frame(ctx)
