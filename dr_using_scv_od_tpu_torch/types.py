"""Tensor containers (counterpart of dr_using_scv_od_tpu/types.py).

Same field names and conventions as the JAX pytrees: point arrays are
padded to `ShapeConfig.max_points` with a `valid` mask, cluster tables to
`ShapeConfig.max_clusters`, and the dense curved-voxel grid is flat over
`az * R * S + r * S + s` (reference src/ssc.cpp:188).

`stack` and `take` stand in for `jax.tree.map` over a frame axis.
"""

from __future__ import annotations

import dataclasses

import torch

# Cluster type codes (reference: ssc/building_, tree_, car_ in
# config/semantickitti.yaml:57-59).
TYPE_NONE = -1
TYPE_BUILDING = 0
TYPE_TREE = 1
TYPE_CAR = 2

# Cluster motion state (reference: Cluster::state, include/utility.h:155).
STATE_UNKNOWN = -1
STATE_STATIC = 0
STATE_DYNAMIC = 1


class _Fields:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PointCloud(_Fields):
    """Padded point batch: xyz [N,3] f32, intensity [N] f32, valid [N] bool,
    optional raw label [N] int32."""

    xyz: torch.Tensor
    intensity: torch.Tensor
    valid: torch.Tensor
    label: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class VoxelGrid(_Fields):
    """Dense per-voxel statistics over the flat grid."""

    count: torch.Tensor           # [G] int32 points per voxel
    intensity_mean: torch.Tensor  # [G] f32
    intensity_var: torch.Tensor   # [G] f32

    @property
    def occupied(self) -> torch.Tensor:
        return self.count > 0


@dataclasses.dataclass(frozen=True)
class ClusterTable(_Fields):
    """Padded per-frame cluster set; row c is compact cluster id c."""

    valid: torch.Tensor      # [C] bool
    n_points: torch.Tensor   # [C] int32
    n_voxels: torch.Tensor   # [C] int32
    bbox_min: torch.Tensor   # [C,3] f32
    bbox_max: torch.Tensor   # [C,3] f32
    type: torch.Tensor       # [C] int32 TYPE_*
    state: torch.Tensor      # [C] int32 STATE_*
    track_id: torch.Tensor   # [C] int32 (-1 = unassigned)


@dataclasses.dataclass(frozen=True)
class FrameState(_Fields):
    """One processed frame; `label_grid` [G] and `point_cluster` [N] hold
    compact cluster ids (-1 none), `point_route` the ROUTE_* codes of
    models/segmentation.py."""

    points: PointCloud
    grid: VoxelGrid
    label_grid: torch.Tensor     # [G] int32
    clusters: ClusterTable
    point_voxel: torch.Tensor    # [N] int32
    point_cluster: torch.Tensor  # [N] int32
    pose: torch.Tensor           # [4,4] f32 world_T_sensor
    point_route: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class Overflow(_Fields):
    """What each static-shape cap dropped (scalar int32 counters)."""

    points_dropped: torch.Tensor
    clusters_dropped: torch.Tensor
    patch_pts_dropped: torch.Tensor


def empty_overflow(device: torch.device | str) -> Overflow:
    """All three counters at zero on `device`."""
    def zero():
        return torch.zeros((), dtype=torch.int32, device=device)
    return Overflow(points_dropped=zero(), clusters_dropped=zero(),
                    patch_pts_dropped=zero())


def stack(items):
    """Stack a list of equal-structure containers (dataclasses, NamedTuples
    or tensors) along a new leading axis."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: stack([getattr(it, f.name) for it in items])
            for f in dataclasses.fields(first)})
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(stack(list(col)) for col in zip(*items)))
    raise TypeError(f"cannot stack {type(first).__name__}")


def take(tree, i: int):
    """Index every tensor field of a dataclass of tensors (a stacked
    ClusterTable, say) along its leading axis."""
    return type(tree)(**{f.name: getattr(tree, f.name)[i]
                         for f in dataclasses.fields(tree)})
