"""datadir.card_downsample_share_pct: the share of the scans of the
recorded slam_datadir session that the port's scan stream down-sampled
and padded on the card (cli.stream_scans by
ops/quantize.first_point_per_leaf), 100 x `scan.leaf_card` /
(`scan.leaf_card` + `scan.leaf_host`), from the counts the stream keeps;
None where it counted neither, as a stream that keeps no such count."""

from benchmark.metrics import _datadir


def read(ctx):
    card = _datadir.count(ctx, "scan.leaf_card")
    host = _datadir.count(ctx, "scan.leaf_host")
    if card + host == 0:
        return None
    return 100.0 * card / (card + host)
