"""Curved-voxel segmentation: CVC clustering fused with the RI3 intensity
refinement, compaction, and the bounding-box filter (counterpart of
dr_using_scv_od_tpu/models/segmentation.py; reference SSC::segment,
src/ssc.cpp:637-656).

`segment_frame` clusters through ops/cluster_labels.py, which computes the
union-graph fixpoint on every device: any `cfg.seg.iteration > 0` means
"refine to the fixpoint" (the JAX package's TPU semantics), and
`iteration == 0` turns RI3 off. `refine_by_intensity` is the JAX CPU
path's bounded form: exactly `cfg.seg.iteration` rounds.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import PipelineConfig
from ..types import ClusterTable, VoxelGrid
from ..ops import cluster_labels, clustering, quantize, segment_ops
from . import recognition

# point_route codes for evaluation accounting
ROUTE_PIPELINE = 0      # survives in a live cluster
ROUTE_GROUND = 1        # removed as ground (treated static downstream)
ROUTE_OUT_OF_FOV = 2    # outside curved grid (treated static, ssc.cpp:161-172)
ROUTE_DROPPED = 3       # patchwork drop (neither ground nor nonground)
ROUTE_BBOX_STATIC = 4   # cluster erased by bbox filter, routed static
ROUTE_BBOX_DYNAMIC = 5  # cluster erased by bbox filter, routed dynamic


class SegmentResult(NamedTuple):
    root_grid: torch.Tensor      # [G] int32 per-voxel root label
    label_grid: torch.Tensor     # [G] int32 compact cluster id, -1 empty
    point_cluster: torch.Tensor  # [N] int32 compact cluster id, -1 none
    clusters: ClusterTable
    point_route: torch.Tensor    # [N] int32 ROUTE_*
    n_clusters: torch.Tensor     # scalar int32
    overflow_points: torch.Tensor  # scalar int32 (cluster-cap overflow)
    planar_vox: torch.Tensor     # [G] bool per-voxel planarity
    n_planar: torch.Tensor       # [C] f32 planar-point count per cluster


def refine_by_intensity(root_grid: torch.Tensor, grid: VoxelGrid,
                        cfg: PipelineConfig) -> torch.Tensor:
    """RI3, bounded to `cfg.seg.iteration` rounds (segmentation.py:61-159;
    reference refineClusterByIntensity, src/ssc.cpp:571-635).

    An edge joins occupied voxels v and n within Chebyshev distance
    search_c whose mean intensities differ by <= intensity_diff, when
    var(n) <= intensity_cov and the distance is within v's radius, or
    var(v) <= intensity_cov and the distance is within n's radius (the
    radius is 1 past `far_range_frac` of the range bins, search_c before).
    Each round, every occupied voxel takes the least label over itself and
    its edges, then two sweeps take the least new label over each of the
    round's input labels. Returns [G] int32 labels; empty voxels keep
    theirs."""
    A, R, S = cfg.grid.shape
    sc = cfg.seg
    occ = grid.occupied
    offsets = clustering.forward_offsets(sc.search_c)
    ids, nbr, ok = clustering.occupied_pairs(occ.reshape(A, R, S), offsets)
    far_bin = int(R * sc.far_range_frac)
    cheb = torch.tensor([max(map(abs, d)) for d in offsets],
                        device=ids.device)

    def reach(r):
        return torch.where(r > far_bin, 1, sc.search_c)

    qual = grid.intensity_var <= sc.intensity_cov
    mean = grid.intensity_mean
    ok = ok & ((mean[ids][:, None] - mean[nbr]).abs() <= sc.intensity_diff) \
        & ((qual[nbr] & (cheb <= reach((ids // S) % R)[:, None]))
           | (qual[ids][:, None] & (cheb <= reach((nbr // S) % R))))
    src, dst = ids[:, None].expand_as(nbr)[ok], nbr[ok]

    lab = root_grid.long()
    big = torch.iinfo(torch.int64).max
    for _ in range(sc.iteration):
        new = lab.scatter_reduce(0, src, lab[dst], "amin")
        new = new.scatter_reduce(0, dst, lab[src], "amin")
        for _ in range(2):
            key = torch.where(occ, lab, lab.numel())
            least = torch.full((lab.numel() + 1,), big, dtype=lab.dtype,
                               device=lab.device
                               ).scatter_reduce(0, key, new, "amin")
            new = torch.where(occ, torch.minimum(new, least[key]), new)
            lab = new
    return lab.to(torch.int32)


def segment_frame(xyz: torch.Tensor, intensity: torch.Tensor,
                  nonground: torch.Tensor, ground: torch.Tensor,
                  dropped: torch.Tensor, cfg: PipelineConfig
                  ) -> Tuple[SegmentResult, torch.Tensor, VoxelGrid]:
    """Segment one frame's non-ground cloud. Returns (SegmentResult,
    point_voxel [N] int32, VoxelGrid)."""
    g = cfg.grid.bin_num
    C = cfg.shapes.max_clusters

    _, flat, in_fov = quantize.quantize(xyz, nonground, cfg.grid)
    grid, moments = quantize.voxel_stats_moments(flat, xyz, intensity,
                                                 in_fov, cfg.grid)
    planar_vox = recognition.voxel_planarity_from_moments(
        grid.count, moments, cfg)

    root_grid = cluster_labels.cluster_labels(
        grid.occupied.reshape(cfg.grid.shape), grid.intensity_mean,
        grid.intensity_var, cfg.seg.search_c, cfg.seg.intensity_cov,
        cfg.seg.intensity_diff, cfg.seg.far_range_frac,
        enable_shell=cfg.seg.iteration > 0)

    roots, point_cluster, label_grid, _, overflow = \
        clustering.compact_grid_labels(root_grid, grid.occupied, flat,
                                       in_fov, C, g)

    # per-cluster point counts are the voxel-count-weighted histogram of
    # the label grid (every in-FOV point's voxel carries its cluster)
    n_voxels, (n_points_f, n_planar) = segment_ops.grid_label_hist_multi(
        label_grid, C,
        [grid.count, torch.where(planar_vox, grid.count, 0)])
    n_points = n_points_f.to(torch.int32)
    bbox_min, bbox_max = segment_ops.segment_minmax(xyz, point_cluster,
                                                    in_fov, C)
    alive = roots != g

    # --- bounding-box refinement (src/ssc.cpp:437-467)
    dz = bbox_max[:, 2] - bbox_min[:, 2]
    drop = alive & ((bbox_min[:, 2] > 0.0)
                    | (n_points < cfg.seg.to_be_class)
                    | (dz < cfg.seg.min_cluster_z_extent))
    # eval routing of dropped clusters (the reference's intent at
    # src/ssc.cpp:449-453)
    drop_dynamic = drop & ((bbox_min[:, 2] < cfg.seg.refine_height)
                           | (n_points < cfg.seg.to_be_class))
    alive = alive & ~drop

    label_safe = torch.clamp(label_grid, 0, C - 1).long()
    label_grid = torch.where((label_grid >= 0) & alive[label_safe],
                             label_grid, -1)
    pc_safe = torch.clamp(point_cluster, 0, C - 1).long()
    point_alive = (point_cluster >= 0) & alive[pc_safe]
    point_in_dropped = (point_cluster >= 0) & ~point_alive
    dd_pt = drop_dynamic[pc_safe]

    route = torch.full(xyz.shape[:1], ROUTE_OUT_OF_FOV, dtype=torch.int32,
                       device=xyz.device)
    route = torch.where(ground, ROUTE_GROUND, route)
    route = torch.where(dropped, ROUTE_DROPPED, route)
    route = torch.where(in_fov, ROUTE_PIPELINE, route)
    route = torch.where(point_in_dropped & dd_pt, ROUTE_BBOX_DYNAMIC, route)
    route = torch.where(point_in_dropped & ~dd_pt, ROUTE_BBOX_STATIC, route)
    point_cluster = torch.where(point_alive, point_cluster, -1)

    def unset():
        return torch.full((C,), -1, dtype=torch.int32, device=xyz.device)

    table = ClusterTable(
        valid=alive,
        n_points=n_points,
        n_voxels=n_voxels,
        bbox_min=torch.where(alive[:, None], bbox_min, 0.0),
        bbox_max=torch.where(alive[:, None], bbox_max, 0.0),
        type=unset(),
        state=unset(),
        track_id=unset(),
    )
    result = SegmentResult(
        root_grid=root_grid,
        label_grid=label_grid,
        point_cluster=point_cluster,
        clusters=table,
        point_route=route,
        n_clusters=alive.sum().to(torch.int32),
        overflow_points=overflow,
        planar_vox=planar_vox,
        n_planar=n_planar,
    )
    return result, flat, grid
