"""Curved-voxel quantization, dense per-voxel statistics, voxel centers
and the Cartesian leaf down-sample (counterpart of
dr_using_scv_od_tpu/ops/quantize.py; reference src/ssc.cpp:155-195,
253-289 and 1108-1121).

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
        i = torch.ceil(geometry.div_exact(v - lo, res)).to(torch.int32) - 1
        return torch.clamp(i, 0, n - 1)

    r_idx = _idx(dis, grid.min_dis, grid.range_res, grid.range_num)
    s_idx = _idx(angle, grid.min_angle, grid.sector_res, grid.sector_num)
    a_idx = _idx(azim, grid.min_azimuth, grid.azimuth_res, grid.azimuth_num)

    flat = (a_idx * (grid.range_num * grid.sector_num)
            + r_idx * grid.sector_num + s_idx)
    flat = torch.where(in_fov, flat, -1)
    idx3 = torch.stack([a_idx, r_idx, s_idx], dim=-1)
    return idx3, flat, in_fov


def _intensity_stats(count: torch.Tensor, s1: torch.Tensor,
                     s2: torch.Tensor) -> VoxelGrid:
    """VoxelGrid from per-voxel point counts and intensity sums."""
    safe_n = torch.clamp_min(count, 1.0)
    mean = s1 / safe_n
    # E[x^2] - mean^2 rounded once, as a fused multiply-add rounds it (and
    # as the JAX package's compiled pipeline computes it): mean^2 and the
    # difference are exact in float64. Two float32 roundings would lose up
    # to 2e-3 to cancellation, enough to move a voxel across intensity_cov.
    var = torch.clamp_min(
        ((s2 / safe_n).double() - mean.double() ** 2).to(mean.dtype), 0.0)
    return VoxelGrid(count=count.to(torch.int32), intensity_mean=mean,
                     intensity_var=var)


def voxel_stats(flat_voxel: torch.Tensor, intensity: torch.Tensor,
                in_fov: torch.Tensor, grid: GridConfig) -> VoxelGrid:
    """Per-voxel count, intensity mean and population variance from the
    in-FOV points: the three narrow sums of `voxel_stats_moments`, without
    the xyz moments."""
    seg = torch.where(in_fov, flat_voxel, grid.bin_num)
    ones = in_fov.to(intensity.dtype)
    cols = torch.stack([torch.ones_like(intensity), intensity,
                        intensity * intensity], dim=-1) * ones[:, None]
    s = segment_ops.segment_sum(cols, seg, grid.bin_num)       # [G, 3]
    return _intensity_stats(s[:, 0], s[:, 1], s[:, 2])


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
    return _intensity_stats(s[:, 0], s[:, 1], s[:, 2]), s[:, 3:]


def voxel_centers(grid: GridConfig, device: torch.device | str
                  ) -> torch.Tensor:
    """[G, 3] float32 centers of the curved voxels: x = r cos(s),
    y = r sin(s), z = r tan(a) at the bin centers (quantize.py:125-144;
    the reference's integer-division corners of src/ssc.cpp:271-276 are
    not copied)."""
    A, R, S = grid.shape

    def centers(n, res, lo):
        i = torch.arange(n, dtype=torch.float32, device=device)
        return (i + 0.5) * res + lo

    rc = centers(R, grid.range_res, grid.min_dis)[None, :, None]
    sc = (centers(S, grid.sector_res, grid.min_angle)
          * geometry.DEG2RAD)[None, None]
    ac = (centers(A, grid.azimuth_res, grid.min_azimuth)
          * geometry.DEG2RAD)[:, None, None]
    x = (rc * torch.cos(sc)).expand(A, R, S)
    y = (rc * torch.sin(sc)).expand(A, R, S)
    z = (rc * torch.tan(ac)).expand(A, R, S)
    return torch.stack([x, y, z], dim=-1).reshape(grid.bin_num, 3)


def voxel_downsample(xyz: torch.Tensor, valid: torch.Tensor, leaf: float,
                     bound: float = 200.0) -> torch.Tensor:
    """[N] bool keep-mask of a Cartesian leaf-grid down-sample: the first
    valid point of each occupied leaf, in point order (quantize.py:147-172,
    the stand-in for pcl::VoxelGrid at scan load, src/ssc.cpp:1108-1121).

    Leaf indices truncate (x + bound) / leaf and clip into [0, dim), dim =
    int(2 bound / leaf), as the JAX function does. The leaves are grouped
    by one int64 key and a stable sort, where the JAX function (no 64-bit
    integers) sorts three times."""
    dim = int(2.0 * bound / leaf)
    ijk = torch.clamp(geometry.div_exact(xyz + bound, leaf)
                      .to(torch.int32), 0, dim - 1).long()
    side = dim + 1
    key = (ijk[:, 0] * side + ijk[:, 1]) * side + ijk[:, 2]
    key = torch.where(valid, key, side ** 3)     # invalid points: no leaf
    skey, order = torch.sort(key, stable=True)
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    keep = torch.zeros_like(first)
    keep[order] = first & (skey != side ** 3)
    return keep
