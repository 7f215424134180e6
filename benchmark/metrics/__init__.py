"""Per-layer metrics, one file each, named as BENCHMARK.json names them.
Each has `read(ctx)`, which returns the metric's value from a traced run's
context, or None where it finds nothing to read. The context (built by
the cell's driver and the runner) holds:
  trace            harness.Trace of the profiled stretch
  profiled_frames  frames the profiled stretch ran
  span_s           {span: seconds} of the stretch of synchronised spans
  span_self_s      the same less nested spans (where the cell's driver
                   has them)
  span_frames      frames that stretch ran
and what the cell's driver adds for its metrics (removal_window:
occupied_voxels, the occupied voxels of every profiled frame's
segmentation grid as the reference counts them, and grid_voxels).
"""
