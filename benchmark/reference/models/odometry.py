"""Window odometry: GICP scan-to-scan chains (counterpart of
dr_using_scv_od_tpu/models/odometry.py:33-58). It estimates the world poses
that `pipeline.run_window` takes, in place of ground-truth poses, as `cli
segdf --estimate-poses` does.

The JAX package's `lax.scan` over frame pairs is a Python loop; each pair
builds the voxel map of the earlier scan and registers the later one into
it, coarse to fine (`gicp.register_pyramid`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PipelineConfig
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
    transform (constant velocity)."""
    T_rel = torch.eye(4, dtype=xyz.dtype, device=xyz.device)
    rel, n_corr, err = [], [], []
    for t in range(xyz.shape[0] - 1):
        vm = gicp.build_voxel_map(xyz[t], valid[t], cfg.gicp)
        res = gicp.register_pyramid(xyz[t + 1], valid[t + 1], vm, cfg.gicp,
                                    T_init=T_rel)
        T_rel = res.T
        rel.append(res.T)
        n_corr.append(res.n_corr)
        err.append(res.final_error)
    rel_T = torch.stack(rel)
    return OdometryResult(poses=posegraph.odometry_chain(rel_T), rel_T=rel_T,
                          n_corr=torch.stack(n_corr),
                          final_error=torch.stack(err))
