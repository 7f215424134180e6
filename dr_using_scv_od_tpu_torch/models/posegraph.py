"""Pose-graph helpers (counterpart of dr_using_scv_od_tpu/models/
posegraph.py). Only `odometry_chain` so far: the graph's residuals and its
Gauss-Newton optimizer come with the engine slice."""

from __future__ import annotations

import torch


def odometry_chain(rel_T: torch.Tensor) -> torch.Tensor:
    """Compose relative transforms [F-1, 4, 4] into world poses [F, 4, 4]
    (pose 0 = identity), in order, as the JAX package's `lax.scan`."""
    T = torch.eye(4, dtype=rel_T.dtype, device=rel_T.device)
    poses = [T]
    for rel in rel_T:
        T = T @ rel
        poses.append(T)
    return torch.stack(poses)
