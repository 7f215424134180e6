"""slam.launches_per_frame: CUDA kernels per frame in the profiled SLAM
session (the host dispatch of models/engine.py)."""

from benchmark.metrics import _common


def read(ctx):
    return _common.launches_per_frame(ctx)
