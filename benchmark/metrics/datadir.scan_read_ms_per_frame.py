"""datadir.scan_read_ms_per_frame: ms per frame of the port's `scan_read`
spans (cli.stream_scans' wait for the next scan that
utils/prefetch.ScanPrefetcher has decoded ahead) in the slam_datadir
session run in `timing.recording()` with no profiler."""

from benchmark.metrics import _datadir


def read(ctx):
    return _datadir.span_ms_per_frame(ctx, "scan_read")
