"""Window odometry: GICP scan-to-scan chains and scan-to-map refinement
(counterpart of dr_using_scv_od_tpu/models/odometry.py:33-103). It
estimates the world poses that `pipeline.run_window` takes, in place of
ground-truth poses.

Each `lax.scan` of the JAX package is a Python loop over frame pairs; the
scan-to-map carry is a `gicp.VoxelMap`, merged by addition.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PipelineConfig
from ..ops import geometry
from ..utils import timing
from . import gicp, posegraph


class OdometryResult(NamedTuple):
    poses: torch.Tensor        # [F, 4, 4] world_T_frame (frame 0 = identity)
    rel_T: torch.Tensor        # [F-1, 4, 4] frame_t_T_frame_{t+1}
    n_corr: torch.Tensor       # [F-1] int32
    final_error: torch.Tensor  # [F-1]


def estimate_window_poses(xyz: torch.Tensor, valid: torch.Tensor,
                          cfg: PipelineConfig) -> OdometryResult:
    """Sequential scan-to-scan odometry over a [F, N, 3] window: frame t+1
    registers into frame t, warm-started with the previous relative
    transform (constant velocity). Recorded as span "window_odometry"
    (timing.span), with the F - 1 pairs added to the count
    "odometry.pairs"."""
    with timing.span("window_odometry"):
        timing.count("odometry.pairs", xyz.shape[0] - 1)
        T_rel = torch.eye(4, dtype=xyz.dtype, device=xyz.device)
        rel, n_corr, err = [], [], []
        for t in range(xyz.shape[0] - 1):
            vm = gicp.build_voxel_map(xyz[t], valid[t], cfg.gicp)
            res = gicp.register_pyramid(xyz[t + 1], valid[t + 1], vm,
                                        cfg.gicp, T_init=T_rel)
            T_rel = res.T
            rel.append(res.T)
            n_corr.append(res.n_corr)
            err.append(res.final_error)
        rel_T = torch.stack(rel)
        return OdometryResult(poses=posegraph.odometry_chain(rel_T),
                              rel_T=rel_T, n_corr=torch.stack(n_corr),
                              final_error=torch.stack(err))


def estimate_window_poses_scan_to_map(xyz: torch.Tensor, valid: torch.Tensor,
                                      cfg: PipelineConfig
                                      ) -> OdometryResult:
    """Scan-to-map odometry: each frame registers against the voxel map of
    all previous frames, warped into frame 0 and merged by addition."""
    eye = torch.eye(4, dtype=xyz.dtype, device=xyz.device)
    vm = gicp.build_voxel_map(xyz[0], valid[0], cfg.gicp)
    T_world, T_rel = eye, eye
    poses, rel, n_corr, err = [eye], [], [], []
    for t in range(xyz.shape[0] - 1):
        src = xyz[t + 1]
        # warm start: constant velocity in the world frame
        res = gicp.register_pyramid(src, valid[t + 1], vm, cfg.gicp,
                                    T_init=T_world @ T_rel)
        T_rel = geometry.inverse_se3(T_world) @ res.T
        T_world = res.T
        vm = vm.merge(gicp.build_voxel_map(
            geometry.transform_points(res.T, src), valid[t + 1], cfg.gicp))
        poses.append(res.T)
        rel.append(T_rel)
        n_corr.append(res.n_corr)
        err.append(res.final_error)
    return OdometryResult(poses=torch.stack(poses), rel_T=torch.stack(rel),
                          n_corr=torch.stack(n_corr),
                          final_error=torch.stack(err))


def ate_rmse(est_poses: torch.Tensor, gt_poses: torch.Tensor
             ) -> torch.Tensor:
    """Absolute trajectory error (RMSE of translation), both sequences
    expressed relative to their first pose."""
    e = (geometry.inverse_se3(est_poses[0]) @ est_poses)[:, :3, 3]
    g = (geometry.inverse_se3(gt_poses[0]) @ gt_poses)[:, :3, 3]
    return geometry.sqrt_f32(((e - g) ** 2).sum(-1).mean())
