"""Typed configuration for the TPU-native SCV-OD engine.

Mirrors the parameter surface of the reference's `Utility` base class
(reference: include/utility.h:187-327) and the YAML profiles in
reference config/semantickitti.yaml / config/parkinglot.yaml, re-expressed
as frozen dataclasses so every pipeline function can treat them as static
(hashable) jit arguments.

Unlike the reference (ROS param server -> mutable public members), configs
here are immutable; derived grid dimensions are computed once in
`__post_init__`-style cached properties, matching the reference's
computation at src/ssc.cpp:36-39.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


def _cdiv(a: float, b: float) -> int:
    return int(math.ceil(a / b))


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Curved-voxel (range x sector x azimuth) grid geometry.

    Reference: the APRI quantization constants (src/ssc.cpp:185-188) and the
    grid-dimension computation (src/ssc.cpp:36-39).
    """

    min_dis: float = 1.5      # metres (2-D range)
    max_dis: float = 30.0
    min_angle: float = 0.0    # degrees, polar angle in [0, 360)
    max_angle: float = 360.0
    min_azimuth: float = -40.0  # degrees, elevation angle
    max_azimuth: float = 80.0
    range_res: float = 0.4
    sector_res: float = 1.2
    azimuth_res: float = 2.0

    @property
    def range_num(self) -> int:
        return _cdiv(self.max_dis - self.min_dis, self.range_res)

    @property
    def sector_num(self) -> int:
        return _cdiv(self.max_angle - self.min_angle, self.sector_res)

    @property
    def azimuth_num(self) -> int:
        return _cdiv(self.max_azimuth - self.min_azimuth, self.azimuth_res)

    @property
    def bin_num(self) -> int:
        return self.range_num * self.sector_num * self.azimuth_num

    @property
    def shape(self) -> Tuple[int, int, int]:
        """Dense grid shape (azimuth, range, sector).

        Matches the reference's flat voxel id
        `az * R * S + r * S + s` (src/ssc.cpp:188), i.e. azimuth-major.
        """
        return (self.azimuth_num, self.range_num, self.sector_num)


@dataclasses.dataclass(frozen=True)
class PatchworkConfig:
    """Concentric-Zone-Model ground segmentation parameters.

    Reference: include/patchwork.h:44-132 (hard-coded members of PatchWork).
    """

    sensor_height: float = 1.73
    num_iter: int = 3
    num_lpr: int = 20
    num_min_pts: int = 10
    th_seeds: float = 0.3
    th_dist: float = 0.1
    max_range: float = 80.0
    min_range: float = 2.7
    uprightness_thr: float = 0.707
    adaptive_seed_selection_margin: float = -1.1
    num_zones: int = 4
    num_sectors_each_zone: Tuple[int, ...] = (16, 32, 54, 32)
    num_rings_each_zone: Tuple[int, ...] = (2, 4, 4, 4)
    elevation_thr: Tuple[float, ...] = (-1.2, -0.9984, -0.851, -0.605)
    flatness_thr: Tuple[float, ...] = (0.0, 0.000125, 0.000185, 0.000185)
    # NB: no per-patch point cap. The reference reserves
    # NUM_HEURISTIC_MAX_PTS_IN_PATCH=5000 (patchwork.h:13) for its per-patch
    # point lists; the sort-free formulation (models/patchwork.py) works in
    # segment reductions keyed by patch id, so no cap is needed.

    @property
    def num_rings_of_interest(self) -> int:
        return len(self.elevation_thr)

    @property
    def num_patches(self) -> int:
        return sum(s * r for s, r in zip(self.num_sectors_each_zone,
                                         self.num_rings_each_zone))

    @property
    def min_ranges(self) -> Tuple[float, ...]:
        z2 = (7 * self.min_range + self.max_range) / 8.0
        z3 = (3 * self.min_range + self.max_range) / 4.0
        z4 = (self.min_range + self.max_range) / 2.0
        return (self.min_range, z2, z3, z4)

    @property
    def ring_sizes(self) -> Tuple[float, ...]:
        mr = self.min_ranges
        bounds = mr + (self.max_range,)
        return tuple((bounds[i + 1] - bounds[i]) / self.num_rings_each_zone[i]
                     for i in range(self.num_zones))

    @property
    def sector_sizes(self) -> Tuple[float, ...]:
        return tuple(2.0 * math.pi / n for n in self.num_sectors_each_zone)


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """CVC clustering + refinement parameters.

    Reference: ssc/ params in config/semantickitti.yaml:50-59 and their
    consumption in src/ssc.cpp:299-467, 571-635.
    """

    iteration: int = 3          # RI3 refine iterations
    to_be_class: int = 10       # min points per surviving cluster
    search_c: int = 2           # RI3 neighbourhood Chebyshev radius
    intensity_diff: float = 2.0
    intensity_cov: float = 1.0
    refine_height: float = -0.2
    min_cluster_z_extent: float = 0.2   # hard-coded 0.2 at src/ssc.cpp:445
    # Fraction of range bins beyond which neighbourhoods shrink to radius 1
    # (reference: findVoxelNeighbors, src/ssc.cpp:397-399).
    far_range_frac: float = 0.6
    # Label-propagation iteration cap for the connected-components solve that
    # replaces the reference's mergeClusters rescans (src/ssc.cpp:413-419).
    cc_max_iters: int = 64


@dataclasses.dataclass(frozen=True)
class RecognitionConfig:
    """Rule-based building/tree/car classification.

    Reference: decision tree at src/ssc.cpp:844-892 plus the region-growing
    plane check at src/ssc.cpp:797-832 (replaced here by a per-voxel
    planarity test - PCL region growing is inherently sequential).
    """

    max_z: float = 0.8
    min_z: float = -1.2
    car_square: float = 30.0
    # NB: the reference also declares car_angle_/car_height_ params
    # (utility.h:296-297) but never reads them anywhere in the pipeline;
    # the YAML loader (config_yaml.py) accepts and ignores those keys.
    building_label: int = 0
    tree_label: int = 1
    car_label: int = 2
    # Per-voxel planarity test replacing PCL RegionGrowing ("RPC"):
    # a voxel is planar if it has >= plane_min_pts points and its smallest
    # covariance eigenvalue fraction <= plane_flatness_thr; a cluster is a
    # building if >= plane_ratio of its points lie in planar voxels
    # (reference required >=20% of points in planar segments, src/ssc.cpp:825).
    plane_min_pts: int = 5
    plane_flatness_thr: float = 0.02
    plane_ratio: float = 0.2


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """SCV-OD descriptor matching / dynamic detection.

    Reference: tracking() decision lattice at src/ssc.cpp:1319-1421.
    """

    occupancy: float = 0.4   # voxel-overlap ratio threshold
    # Ablation: the reference's "TC" (tracking compensation) is the
    # split/merge mutation of the next frame (doc/note.txt ablations;
    # the "-TC"-less variant keeps verdicts but skips mutations).
    enable_compensation: bool = True
    # Dynamic-footprint sweep (extension beyond the reference): after the
    # verdict lattice, any point inside the inflated bbox of a cluster
    # judged DYNAMIC is also removed. Catches the dynamic points that never
    # reach the lattice - car-bottom returns misrouted to ground by
    # patchwork, points past the curved grid's max range (the reference
    # bypasses both to its static set, src/ssc.cpp:161-172), and points of
    # bbox-filter-dropped fragments of the same object.
    dynamic_bbox_sweep: bool = True
    sweep_margin: float = 0.3  # bbox inflation (metres)


@dataclasses.dataclass(frozen=True)
class GicpConfig:
    """Voxelized GICP scan-to-scan/scan-to-map registration.

    New capability (the reference consumes ground-truth poses,
    src/ssc.cpp:913-995); designed TPU-first: per-voxel Gaussians with
    batched 3x3 eigendecomp, Gauss-Newton 6-DoF solve.
    """

    voxel_size: float = 1.0
    max_iters: int = 30
    # Gauss-Newton updates per correspondence pass: each outer pass pays
    # the TPU-expensive voxel lookup + target gathers once, then runs this
    # many relinearised steps against the frozen per-voxel Gaussians
    # (correspondences barely move between nearby iterates at ~1 m voxels).
    inner_iters: int = 3
    # Source-cloud budget for the GN solver (static-stride subsample; the
    # target voxel map always uses the full cloud). Gathering target
    # stats per correspondence pass costs ~30 ns/source-point on TPU, so
    # this knob prices the whole solver; 32k keeps 6 DoF vastly
    # over-determined. 0 disables. Beyond-reference perf knob (the
    # reference has no ICP at all, SURVEY 2.2).
    max_source_points: int = 32768
    tolerance: float = 1e-4
    min_pts_per_voxel: int = 4
    # Covariance regularisation: eigenvalues scaled to (1, 1, eps) as in GICP
    plane_eps: float = 1e-3
    max_corr_dist: float = 2.0
    # World bounds of the dense Cartesian voxel grid (sensor/map frame).
    # Points outside are COUNTED (VoxelMap.n_oob / GicpResult.n_oob), never
    # silently dropped. Defaults cover a KITTI scan (+margin for map drift).
    xy_extent: float = 80.0   # grid spans [-xy_extent, +xy_extent) in x, y
    z_min: float = -12.0
    z_max: float = 28.0
    # Coarse-to-fine pyramid (gicp.register_pyramid): first solve against a
    # factor-pooled voxel map with the correspondence radius scaled up,
    # then refine at full resolution. 1 disables. Grid dims must divide by
    # the factor.
    coarse_factor: int = 4
    # Gauss-Newton trust region: per-iteration step caps (metres, radians).
    # Prevents degenerate Hessians from flinging the iterate to infinity
    # when correspondences collapse.
    max_step_t: float = 2.0
    max_step_r: float = 0.35
    # Registration failure detection: below this many correspondences, or
    # above this relative motion per pair (metres - physically implausible
    # for consecutive scans), the result is flagged failed and callers fall
    # back to the previous GOOD relative transform (constant velocity),
    # counting the event - never silently diverging, never compounding a
    # garbage estimate.
    min_fallback_corr: int = 50
    max_rel_motion: float = 10.0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """Static tensor shape caps (TPU programs are traced once; every
    data-dependent size in the reference becomes a padded cap + overflow
    counter here)."""

    max_points: int = 131072      # points per scan after load
    max_clusters: int = 512       # clusters per frame after compaction
    # car-cluster points fed to tracking per frame (compacted before the
    # dedup sort; cars are a small fraction of a scan, and sorting the
    # full point set dominated tracking cost on TPU)
    max_track_points: int = 16384


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level configuration bundle (analog of the whole `Utility` param
    block, include/utility.h:187-327)."""

    grid: GridConfig = dataclasses.field(default_factory=GridConfig)
    patchwork: PatchworkConfig = dataclasses.field(default_factory=PatchworkConfig)
    seg: SegmentationConfig = dataclasses.field(default_factory=SegmentationConfig)
    recog: RecognitionConfig = dataclasses.field(default_factory=RecognitionConfig)
    track: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    gicp: GicpConfig = dataclasses.field(default_factory=GicpConfig)
    shapes: ShapeConfig = dataclasses.field(default_factory=ShapeConfig)

    sensor_height: float = 1.73
    max_intensity: float = 255.0
    skip: int = 5
    dynamic_labels: Tuple[int, ...] = (252, 253, 254, 255, 256, 257, 258, 259)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def semantickitti() -> PipelineConfig:
    """Profile matching reference config/semantickitti.yaml."""
    return PipelineConfig()


def parkinglot() -> PipelineConfig:
    """Profile matching reference config/parkinglot.yaml (PCD sessions,
    occupancy 0.8, skip 1)."""
    return PipelineConfig(
        track=TrackingConfig(occupancy=0.8),
        skip=1,
    )


def tiny_test() -> PipelineConfig:
    """Small grid + small caps for fast CPU unit tests."""
    return PipelineConfig(
        grid=GridConfig(min_dis=1.0, max_dis=17.0, range_res=1.0,
                        sector_res=15.0, azimuth_res=10.0,
                        min_azimuth=-40.0, max_azimuth=80.0),
        shapes=ShapeConfig(max_points=4096, max_clusters=64,
                           max_track_points=1024),
        gicp=GicpConfig(xy_extent=40.0),
    )
