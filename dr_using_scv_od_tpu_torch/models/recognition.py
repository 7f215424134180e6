"""Rule-based building / tree / car recognition (counterpart of
dr_using_scv_od_tpu/models/recognition.py; reference decision tree
src/ssc.cpp:844-892):

    area > car_square          -> planar ? building : tree
    else if min_z < cfg.min_z
         and area < car_square
         and max_z < cfg.max_z -> car
    else                       -> tree

"planar" replaces PCL region growing: >= plane_ratio of the cluster's
points lie in voxels whose covariance fails positive definiteness after
subtracting plane_flatness_thr * trace (Sylvester's criterion).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import PipelineConfig
from ..types import TYPE_BUILDING, TYPE_CAR, TYPE_TREE, ClusterTable
from ..ops import geometry, segment_ops


class Features(NamedTuple):
    """The live slots of the reference's 11-dim feature matrix."""
    max_z: torch.Tensor         # [C] slot 6
    area: torch.Tensor          # [C] slot 7 (dx * dy)
    angle_spread: torch.Tensor  # [C] slot 8
    min_z: torch.Tensor         # [C] slot 9
    planar_ratio: torch.Tensor  # [C] RPC replacement


def _planarity_from_sums(n, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz,
                         cfg: PipelineConfig) -> torch.Tensor:
    """[G] bool planarity from per-voxel point counts (float) and raw
    moment sums."""
    safe_n = torch.clamp_min(n, 1.0)
    mx, my, mz = sx / safe_n, sy / safe_n, sz / safe_n
    cxx = sxx / safe_n - mx * mx
    cyy = syy / safe_n - my * my
    czz = szz / safe_n - mz * mz
    cxy = sxy / safe_n - mx * my
    cxz = sxz / safe_n - mx * mz
    cyz = syz / safe_n - my * mz
    tr = torch.clamp_min(cxx + cyy + czz, 1e-12)
    t = cfg.recog.plane_flatness_thr * tr
    a00, a11, a22 = cxx - t, cyy - t, czz - t
    d1 = a00
    d2 = a00 * a11 - cxy * cxy
    d3 = (a00 * (a11 * a22 - cyz * cyz)
          - cxy * (cxy * a22 - cyz * cxz)
          + cxz * (cxy * cyz - a11 * cxz))
    pos_def = (d1 > 0.0) & (d2 > 0.0) & (d3 > 0.0)   # e_lo > thr * tr
    return (n >= cfg.recog.plane_min_pts) & ~pos_def


def voxel_planarity_from_moments(count: torch.Tensor, moments: torch.Tensor,
                                 cfg: PipelineConfig) -> torch.Tensor:
    """[G] bool planarity from the raw per-voxel moment sums
    (sx, sy, sz, sxx, syy, szz, sxy, sxz, syz) of
    ops/quantize.voxel_stats_moments."""
    return _planarity_from_sums(count.to(torch.float32), *moments.unbind(-1),
                                cfg)


def voxel_planarity(xyz: torch.Tensor, point_voxel: torch.Tensor,
                    in_fov: torch.Tensor, cfg: PipelineConfig
                    ) -> torch.Tensor:
    """[G] bool planarity from the points themselves (recognition.py:87):
    the moment sums of the `in_fov` points of each voxel, for callers
    without the segmentation stage's moment sums."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    cols = torch.stack([torch.ones_like(x), x, y, z, x * x, y * y, z * z,
                        x * y, x * z, y * z], dim=-1)
    sums = segment_ops.segment_sum(cols, torch.where(in_fov, point_voxel, -1),
                                   cfg.grid.bin_num)
    return _planarity_from_sums(*sums.unbind(-1), cfg)


def recognize(table: ClusterTable, n_planar: torch.Tensor,
              cfg: PipelineConfig) -> Tuple[ClusterTable, Features]:
    """Classify every live cluster from its bbox and planar-point count
    ([C], the segmentation stage's histogram). Returns the table with
    `type` set (-1 on dead rows) and the features."""
    n_pts = torch.clamp_min(table.n_points, 1)
    planar_ratio = n_planar.to(torch.float32) / n_pts.to(torch.float32)

    dx = table.bbox_max[:, 0] - table.bbox_min[:, 0]
    dy = table.bbox_max[:, 1] - table.bbox_min[:, 1]
    area = dx * dy
    max_z = table.bbox_max[:, 2]
    min_z = table.bbox_min[:, 2]
    angle_spread = (geometry.polar_angle_deg(table.bbox_max)
                    - geometry.polar_angle_deg(table.bbox_min)).abs()

    is_big = area > cfg.recog.car_square
    is_planar = planar_ratio >= cfg.recog.plane_ratio
    is_car = ((min_z < cfg.recog.min_z)
              & (area < cfg.recog.car_square)
              & (max_z < cfg.recog.max_z))

    typ = torch.where(is_big,
                      torch.where(is_planar, TYPE_BUILDING, TYPE_TREE),
                      torch.where(is_car, TYPE_CAR, TYPE_TREE))
    typ = torch.where(table.valid, typ, -1).to(torch.int32)
    feats = Features(max_z=max_z, area=area, angle_spread=angle_spread,
                     min_z=min_z, planar_ratio=planar_ratio)
    return table.replace(type=typ), feats


def recognize_points(table: ClusterTable, xyz: torch.Tensor,
                     point_cluster: torch.Tensor, point_voxel: torch.Tensor,
                     cfg: PipelineConfig,
                     label_grid: torch.Tensor | None = None,
                     voxel_count: torch.Tensor | None = None,
                     planar_vox: torch.Tensor | None = None
                     ) -> Tuple[ClusterTable, Features]:
    """`recognize` with the JAX function's argument list
    (recognition.py:114-178): the planar-point count of each cluster is
    computed here, on the branch the JAX function takes. Without
    `planar_vox`, voxel planarity comes from the points of live clusters
    (`voxel_planarity`); with `label_grid` and `voxel_count` the count is a
    voxel-count-weighted histogram of the label grid, else a per-point
    count of points in planar voxels."""
    C = table.valid.shape[0]
    valid_pt = point_cluster >= 0
    if planar_vox is None:
        planar_vox = voxel_planarity(xyz, point_voxel, valid_pt, cfg)
    if label_grid is not None and voxel_count is not None:
        n_planar = segment_ops.grid_label_counts(
            label_grid, C, weights=torch.where(planar_vox, voxel_count, 0))
    else:
        pv_safe = torch.clamp(point_voxel, 0, cfg.grid.bin_num - 1).long()
        n_planar = segment_ops.segment_count(
            point_cluster, valid_pt & planar_vox[pv_safe], C)
    return recognize(table, n_planar, cfg)
