"""slam.pgo_ms_per_frame: ms per frame of the host-clock spans around the
engine's _run_pgo (models/posegraph.py) and the self time of its session
finalize (whose own solve is a _run_pgo span), in the session run with no
profiler (unsynchronised: see drivers/slam_session.py); nothing where no
solve ran."""

from benchmark.metrics import _common


def read(ctx):
    return _common.span_ms_per_frame(ctx, "pgo", self_spans=("finalize",))
