"""Curved-voxel quantization and dense per-voxel statistics (counterpart
of dr_using_scv_od_tpu/ops/quantize.py:29-122; reference
src/ssc.cpp:155-195 and 253-289).

Indices are clipped into [0, n-1], as in the JAX package (the reference's
`ceil(...) - 1` yields -1 at the lower bound).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import GridConfig
from ..types import VoxelGrid
from . import geometry, segment_ops


def quantize(xyz: torch.Tensor, valid: torch.Tensor, grid: GridConfig
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-point curved-voxel coordinates: (idx3 [N,3] int32 as (azimuth,
    range, sector), flat voxel id [N] int32 with -1 out of FOV, in_fov [N]
    bool)."""
    dis = geometry.range2d(xyz)
    angle = geometry.polar_angle_deg(xyz)
    azim = geometry.azimuth_deg(xyz)

    in_fov = (
        valid
        & (dis >= grid.min_dis) & (dis <= grid.max_dis)
        & (angle >= grid.min_angle) & (angle <= grid.max_angle)
        & (azim >= grid.min_azimuth) & (azim <= grid.max_azimuth)
    )

    def _idx(v, lo, res, n):
        i = torch.ceil((v - lo) / res).to(torch.int32) - 1
        return torch.clamp(i, 0, n - 1)

    r_idx = _idx(dis, grid.min_dis, grid.range_res, grid.range_num)
    s_idx = _idx(angle, grid.min_angle, grid.sector_res, grid.sector_num)
    a_idx = _idx(azim, grid.min_azimuth, grid.azimuth_res, grid.azimuth_num)

    flat = (a_idx * (grid.range_num * grid.sector_num)
            + r_idx * grid.sector_num + s_idx)
    flat = torch.where(in_fov, flat, -1)
    idx3 = torch.stack([a_idx, r_idx, s_idx], dim=-1)
    return idx3, flat, in_fov


def voxel_stats_moments(flat_voxel: torch.Tensor, xyz: torch.Tensor,
                        intensity: torch.Tensor, in_fov: torch.Tensor,
                        grid: GridConfig) -> Tuple[VoxelGrid, torch.Tensor]:
    """Per-voxel count, intensity mean and population variance
    (E[x^2] - mean^2, the JAX package's formula) plus raw xyz moment sums
    [G, 9] (sx, sy, sz, sxx, syy, szz, sxy, sxz, syz), from one [N, 12]
    segment sum into the G voxels.

    The segment sum is `segment_ops.segment_sum`: a stable sort by flat id
    followed by a sequential per-voxel sum, so the result is the same on
    every run and device order does not enter it."""
    g = grid.bin_num
    seg = torch.where(in_fov, flat_voxel, g)
    ones = in_fov.to(xyz.dtype)
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    cols = torch.stack([
        torch.ones_like(x), intensity, intensity * intensity,
        x, y, z, x * x, y * y, z * z, x * y, x * z, y * z,
    ], dim=-1) * ones[:, None]
    s = segment_ops.segment_sum(cols, seg, g)                 # [G, 12]
    count = s[:, 0]
    safe_n = torch.clamp_min(count, 1.0)
    mean = s[:, 1] / safe_n
    # E[x^2] - mean^2 rounded once, as a fused multiply-add rounds it (and
    # as the JAX package's compiled pipeline computes it): mean^2 and the
    # difference are exact in float64. Two float32 roundings would lose up
    # to 2e-3 to cancellation, enough to move a voxel across intensity_cov.
    var = torch.clamp_min(
        ((s[:, 2] / safe_n).double() - mean.double() ** 2).to(mean.dtype),
        0.0)
    vg = VoxelGrid(count=count.to(torch.int32), intensity_mean=mean,
                   intensity_var=var)
    return vg, s[:, 3:]
