"""Frame and window drivers (counterpart of
dr_using_scv_od_tpu/models/pipeline.py; reference SSC::segDF,
src/ssc.cpp:1428-1548): per frame, ground removal -> curved-voxel
segmentation -> recognition; then pairwise tracking over the window and
the per-point dynamic verdicts.

The frame loop is a plain Python loop (the JAX package's vmap / lax.map);
the kernels of each frame run on the device of the inputs.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from ..config import PipelineConfig
from ..types import (STATE_DYNAMIC, ClusterTable, FrameState, PointCloud,
                     stack)
from ..utils import timing
from . import odometry, patchwork, recognition, segmentation, tracking


class FrameOutput(NamedTuple):
    state: FrameState
    features: recognition.Features
    n_clusters: torch.Tensor
    overflow_points: torch.Tensor


def process_frame(xyz: torch.Tensor, intensity: torch.Tensor,
                  valid: torch.Tensor, pose: torch.Tensor,
                  cfg: PipelineConfig) -> FrameOutput:
    """Single-frame pipeline: ground removal -> curved-voxel build ->
    clustering + refinement -> bbox filter -> recognition."""
    with timing.span("patchwork"):
        pw = patchwork.estimate_ground(xyz, valid, cfg.patchwork)
    with timing.span("segmentation"):
        seg, point_voxel, grid = segmentation.segment_frame(
            xyz, intensity, pw.nonground, pw.ground, pw.dropped, cfg)
    with timing.span("recognition"):
        table, feats = recognition.recognize(seg.clusters, seg.n_planar, cfg)
    state = FrameState(
        points=PointCloud(xyz=xyz, intensity=intensity, valid=valid),
        grid=grid,
        label_grid=seg.label_grid,
        clusters=table,
        point_voxel=point_voxel,
        point_cluster=seg.point_cluster,
        pose=pose,
        point_route=seg.point_route,
    )
    return FrameOutput(state=state, features=feats,
                       n_clusters=seg.n_clusters,
                       overflow_points=seg.overflow_points)


def process_window(xyz: torch.Tensor, intensity: torch.Tensor,
                   valid: torch.Tensor, poses: torch.Tensor,
                   cfg: PipelineConfig) -> FrameOutput:
    """process_frame over a [F, ...] window, stacked on the frame axis."""
    return stack([process_frame(xyz[f], intensity[f], valid[f], poses[f],
                                cfg)
                  for f in range(xyz.shape[0])])


def _dynamic_bbox_sweep(xyz: torch.Tensor, tables: ClusterTable,
                        cfg: PipelineConfig) -> torch.Tensor:
    """[F,N] bool: the point lies inside the inflated bbox of a same-frame
    cluster judged DYNAMIC (TrackingConfig.dynamic_bbox_sweep). Chunked
    over cluster rows so the [F, N, chunk, 3] compare stays small."""
    F, N, _ = xyz.shape
    C = tables.valid.shape[1]
    m = cfg.track.sweep_margin
    dyn = (tables.valid & (tables.state == STATE_DYNAMIC))[..., None]
    big = torch.finfo(torch.float32).max / 4
    lo = torch.where(dyn, tables.bbox_min - m, big)          # [F,C,3]
    hi = torch.where(dyn, tables.bbox_max + m, -big)
    out = torch.zeros((F, N), dtype=torch.bool, device=xyz.device)
    chunk = min(64, C)
    p = xyz[:, :, None, :]
    for k in range(0, C, chunk):
        inside = ((p >= lo[:, None, k:k + chunk])
                  & (p <= hi[:, None, k:k + chunk])).all(-1)
        out |= inside.any(2)
    return out


class WindowResult(NamedTuple):
    frames: FrameOutput            # stacked per-frame outputs (pre-tracking)
    tables: ClusterTable           # finalized ClusterTable [F, C]
    label_grids: torch.Tensor      # mutated label grids [F, G]
    point_cluster: torch.Tensor    # [F, N] final cluster per point
    removed: torch.Tensor          # [F, N] bool judged dynamic, removed
    n_dynamic: torch.Tensor        # [F] per-pair dynamic verdicts
    new_row_overflow: torch.Tensor      # ran out of cluster rows
    track_point_overflow: torch.Tensor  # points past max_track_points
    track_counter: torch.Tensor    # next unassigned track id (streaming)


def run_window(xyz: torch.Tensor, intensity: torch.Tensor,
               valid: torch.Tensor, poses: torch.Tensor,
               cfg: PipelineConfig, bbox_dropped_dynamic: bool = False,
               init_track=None) -> WindowResult:
    """The batch pipeline over one window: per-frame segmentation, pairwise
    tracking, and the final per-point dynamic verdicts.

    Inputs: xyz [F,N,3] f32, intensity [F,N] f32, valid [F,N] bool,
    poses [F,4,4] f32 world_T_sensor, all on one device.
    `bbox_dropped_dynamic` also removes the points of clusters that the
    bbox filter erased and routed dynamic (evaluation only). `init_track`:
    optional streaming carry (table, label_grid, counter) for the first
    frame (interop.track_carry_from_numpy builds one from a JAX run).
    Recorded as span "run_window" (timing.span)."""
    with timing.span("run_window"):
        frames = process_window(xyz, intensity, valid, poses, cfg)

        in_grid = frames.state.point_voxel >= 0
        with timing.span("tracking"):
            tr = tracking.track_window(
                xyz, frames.state.point_voxel, in_grid & valid,
                frames.state.label_grid, frames.state.clusters, poses, cfg,
                init_carry=init_track)

        C = cfg.shapes.max_clusters
        pc = tr.point_cluster
        dyn_row = tr.tables.state == STATE_DYNAMIC        # [F, C]
        is_dyn = dyn_row.gather(1, torch.clamp(pc, 0, C - 1).long())
        removed = (pc >= 0) & is_dyn
        if bbox_dropped_dynamic:
            removed = removed | (frames.state.point_route
                                 == segmentation.ROUTE_BBOX_DYNAMIC)
        if cfg.track.dynamic_bbox_sweep:
            removed = removed | _dynamic_bbox_sweep(xyz, tr.tables, cfg)
        removed = removed & valid

        return WindowResult(frames=frames, tables=tr.tables,
                            label_grids=tr.label_grids, point_cluster=pc,
                            removed=removed, n_dynamic=tr.n_dynamic,
                            new_row_overflow=tr.new_row_overflow,
                            track_point_overflow=tr.track_point_overflow,
                            track_counter=tr.counter)


class SegdfResult(NamedTuple):
    poses: torch.Tensor            # [F, 4, 4] the poses run_window took
    window: WindowResult


def segdf_window(xyz: torch.Tensor, intensity: torch.Tensor,
                 valid: torch.Tensor, poses: Optional[torch.Tensor],
                 cfg: PipelineConfig, *, estimate_poses: bool,
                 timer: Optional[timing.StageTimer] = None) -> SegdfResult:
    """Offline removal of one window, as `cli segdf` runs it: with
    `estimate_poses` the window's poses come from scan-to-scan GICP
    (`odometry.estimate_window_poses`, and `poses` may be None), else
    `poses` are taken as given; then `run_window` on them.

    With a `timer` the two steps are its stages "odometry" and "pipeline",
    each ended by a wait on the device, so that a stage's time holds its
    device work."""
    stage = (timer.stage if timer is not None
             else lambda name: contextlib.nullcontext())
    if estimate_poses:
        with stage("odometry"):
            poses = odometry.estimate_window_poses(xyz, valid, cfg).poses
            if timer is not None:
                timing.sync(poses)
    with stage("pipeline"):
        res = run_window(xyz, intensity, valid, poses, cfg)
        if timer is not None:
            timing.sync(res.removed)
    return SegdfResult(poses=poses, window=res)
