"""datadir.native_read_share_pct: the share of the scans of the recorded
slam_datadir session that the C++ prefetch ring decoded
(utils/prefetch.ScanPrefetcher's native tier), 100 x `scan.native` /
(`scan.native` + `scan.python`), from the counts the port's scan stream
keeps; None where it kept none."""

from benchmark.metrics import _datadir


def read(ctx):
    native = _datadir.count(ctx, "scan.native")
    python = _datadir.count(ctx, "scan.python")
    if native + python == 0:
        return None
    return 100.0 * native / (native + python)
