"""Tensor parallelism: one scan's voxel statistics split over ranks
(counterpart of dr_using_scv_od_tpu/parallel/tensor_parallel.py).

Each rank takes a contiguous shard of the scan's points, sums its shard
into a private [G] grid (count, sum of intensity, sum of its square: the
port's order-exact segment sums) and one all-reduce of the three sums
gives every rank the scan's grid, from which mean and variance follow as in
the JAX function. Counts are exact; the float sums add the ranks' partial
sums in the collective's order, so they depend on the number of ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import GridConfig
from ..ops import quantize, segment_ops
from ..types import VoxelGrid
from . import mesh


def tp_voxel_stats(xyz: torch.Tensor, intensity: torch.Tensor,
                   valid: torch.Tensor, grid_cfg: GridConfig,
                   group=None) -> VoxelGrid:
    """Voxel statistics of one scan ([N] points, N divisible by the number
    of ranks), called on every rank with the whole scan; every rank gets
    the whole grid."""
    W, r = mesh.world_size(group), mesh.rank(group)
    shard = mesh.frame_block(xyz.shape[0], r, W)
    xyz, intensity, valid = xyz[shard], intensity[shard], valid[shard]
    _, flat, in_fov = quantize.quantize(xyz, valid, grid_cfg)
    g = grid_cfg.bin_num
    zero = torch.zeros_like(intensity)
    cols = torch.stack([in_fov.to(torch.float32),
                        torch.where(in_fov, intensity, zero),
                        torch.where(in_fov, intensity * intensity, zero)], -1)
    s = segment_ops.segment_sum(cols, torch.where(in_fov, flat, g), g)
    # combine partial sums across the point shards
    dist.all_reduce(s, group=group)
    count, s1, s2 = s.unbind(-1)
    safe = torch.clamp_min(count, 1.0)
    mean = s1 / safe
    # E[x^2] - mean^2 rounded once, as the JAX function's compiled form
    # rounds it (see ops/quantize.voxel_stats_moments)
    var = torch.clamp_min(
        ((s2 / safe).double() - mean.double() ** 2).to(mean.dtype), 0.0)
    return VoxelGrid(count=count.to(torch.int32), intensity_mean=mean,
                     intensity_var=var)
