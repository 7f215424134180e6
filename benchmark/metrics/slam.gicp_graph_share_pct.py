"""slam.gicp_graph_share_pct: the share of `gicp.register` calls in a
profiled SLAM session that replayed a captured CUDA graph, 100 x graph /
(graph + eager), from the named counts of the port's recorder
(program_record.profiled). None where the recorder keeps no counts or no
registration ran."""

from benchmark import program_record


def read(ctx):
    rec = program_record.profiled(ctx)
    counts = getattr(rec, "counts", None)
    if not counts:
        return None
    graph, eager = counts.get("gicp.graph", 0), counts.get("gicp.eager", 0)
    if graph + eager == 0:
        return None
    return 100.0 * graph / (graph + eager)
