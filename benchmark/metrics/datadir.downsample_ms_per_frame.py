"""datadir.downsample_ms_per_frame: ms per frame of the port's `downsample`
spans (cli.stream_scans: utils/io_kitti._voxel_downsample_np at 0.08 m and
the padding, on the host) in the slam_datadir session run in
`timing.recording()` with no profiler. Host clock, no sync: the
down-sample launches nothing."""

from benchmark.metrics import _datadir


def read(ctx):
    return _datadir.span_ms_per_frame(ctx, "downsample")
