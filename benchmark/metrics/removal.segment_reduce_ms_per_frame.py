"""removal.segment_reduce_ms_per_frame: device ms per frame of the kernels
of torch.segment_reduce (ops/segment_ops.py), the kernels whose name holds
PATTERN, in the profiled removal windows."""

from benchmark.metrics import _common

PATTERN = "segment_reduce"


def read(ctx):
    return _common.device_ms_per_frame(ctx, PATTERN)
