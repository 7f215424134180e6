"""Scaling harness: frames/s of the sharded window at 1..N ranks
(counterpart of dr_using_scv_od_tpu/parallel/scaling.py).

Called on every rank of the world with the whole window. For each rank
count n it runs `sharded_run_window` on the first n ranks (the others
wait), times `reps` runs on rank 0's clock after one warm-up, and gives
every rank the same table.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch
import torch.distributed as dist

from ..config import PipelineConfig
from . import mesh, sharded_pipeline


def measure_scaling(xyz: torch.Tensor, intensity: torch.Tensor,
                    valid: torch.Tensor, poses: torch.Tensor,
                    cfg: PipelineConfig, device_counts: List[int],
                    reps: int = 3) -> List[Dict]:
    """Rows {devices, frames_per_s, efficiency} for each rank count that
    divides the window and fits the world, efficiency against the first
    row's frames/s."""
    F = xyz.shape[0]
    world, me = mesh.world_size(), mesh.rank()
    rows = []
    base_fps = None
    for n in device_counts:
        if F % n != 0 or n > world:
            continue
        group = mesh.subgroup(n)
        dt = torch.zeros((), dtype=torch.float64, device=xyz.device)
        if me < n:
            def run():
                removed, _, _ = sharded_pipeline.sharded_run_window(
                    xyz, intensity, valid, poses, cfg, group)
                removed[0, :1].cpu()               # sync
            run()
            t0 = time.perf_counter()
            for _ in range(reps):
                run()
            dt.fill_((time.perf_counter() - t0) / reps)
        dist.broadcast(dt, 0)
        fps = F / float(dt)
        if base_fps is None:
            base_fps = fps
        rows.append({"devices": n, "frames_per_s": fps,
                     "efficiency": fps / (base_fps * n)})
    return rows
