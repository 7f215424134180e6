"""Synthetic labeled LiDAR scene generator: the benchmark's frozen copy of
dr_using_scv_od_tpu_torch/utils/synthetic.py, with two additions for
windows longer than the default scene (SceneSpec.path_frames and the
"ego_wrap" mover path; see SceneSpec). Nothing else changed, so a spec
that uses neither renders what the port's copy renders.

The reference validates only against SemanticKITTI (not shipped here); this
module fabricates scan windows with the same statistical shape - a ground
plane, buildings (large planar walls), trees (tall scattered blobs), parked
cars and moving cars - each point carrying a SemanticKITTI-style label so
the PR/RR/F1 harness (eval/metrics.py, after tool/analysis.py) runs
end-to-end without the dataset.

Labels follow the SemanticKITTI convention used by the reference
(config/semantickitti.yaml:62, tool/analysis.py:6):
  40 = road(ground), 50 = building, 70 = vegetation, 10 = car (static),
  252 = moving-car (dynamic).

Geometry is emitted in the sensor frame per scan, with world poses driving
both ego motion and the moving cars, mimicking the KITTI setup the
reference loads via poses.txt (src/ssc.cpp:913-995).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

LABEL_GROUND = 40
LABEL_BUILDING = 50
LABEL_TREE = 70
LABEL_CAR_STATIC = 10
LABEL_CAR_MOVING = 252


@dataclasses.dataclass
class SceneSpec:
    n_buildings: int = 6
    n_trees: int = 10
    n_parked_cars: int = 6
    n_moving_cars: int = 3
    ground_pts: int = 40000
    building_pts: int = 4000
    tree_pts: int = 1200
    car_pts: int = 900
    extent: float = 28.0
    sensor_height: float = 1.73
    # Per-frame displacements model already-skipped windows (the reference
    # processes every `skip`=5th scan, src/ssc.cpp:944): relative
    # car-vs-ego motion must clearly exceed a car length for a dynamic
    # verdict, just as in the real data.
    ego_speed: float = 1.5          # m per frame along +x
    moving_speed: float = 6.5       # m per frame for dynamic cars
    # Mover path: "line" (default - drives straight, eventually exits the
    # sensor range like real traffic) or "pingpong" (reflects inside the
    # corridor so dynamics are present in EVERY frame of arbitrarily long
    # windows - used by the multichip dryrun to distinguish "scene went
    # empty" from "sharded halo dropped verdicts").
    mover_path: str = "line"
    # Long line windows (benchmark addition): with path_frames > 0 the line
    # scene's static objects are drawn once per tile of 3 * extent metres
    # along x (the default scene's own span, -extent .. 2 * extent), for
    # every tile that a frame of the first `path_frames` frames can see, so
    # each frame has the default density; "ego_wrap" movers keep their
    # world speed but wrap inside +-0.9 * extent of the ego along x, so
    # they stay in view in every frame.
    path_frames: int = 0
    # Hard-scene knobs (accuracy-floor stress tests; round-3 verdict #7):
    # cars parked flush against building walls - inside RI3's +-2-voxel
    # intensity-fusion range, the regime where cluster fusion could eat a
    # car into the building
    wall_parked_cars: int = 0
    # frame at which moving car 0 STOPS and stays parked (the reference's
    # hardest case: a dynamic object becoming static mid-window, served by
    # its split branch src/ssc.cpp:1351-1374); None = never stops
    stop_frame: int | None = None
    noise: float = 0.02
    seed: int = 0
    # Trajectory shape: "line" (default, original behaviour) or "loop"
    # (a closed circle revisiting its start - exercises loop closure;
    # heading follows the tangent so revisit scans are yaw-rotated).
    trajectory: str = "line"
    loop_radius: float = 18.0
    loop_frames: int = 30           # frames per full circle


def pose_at(spec: SceneSpec, frame: int) -> np.ndarray:
    """World_T_sensor [4,4] for a frame along the configured trajectory."""
    pose = np.eye(4, dtype=np.float32)
    if spec.trajectory == "loop":
        a = 2 * np.pi * frame / spec.loop_frames
        R = spec.loop_radius
        # start at origin heading +x; circle center at (0, R)
        pose[0, 3] = R * np.sin(a)
        pose[1, 3] = R * (1.0 - np.cos(a))
        c, s = np.cos(a), np.sin(a)
        pose[:2, :2] = np.array([[c, -s], [s, c]], np.float32)
    else:
        pose[0, 3] = spec.ego_speed * frame
    return pose


def _box_points(rng, center, size, n, noise, shell=True):
    """Points on the surface of an axis-aligned box (walls of buildings /
    bodies of cars read as planar patches to LiDAR)."""
    c = np.asarray(center, np.float64)
    s = np.asarray(size, np.float64)
    if shell:
        # sample the 4 side faces + top
        faces = rng.integers(0, 5, size=n)
        u = rng.uniform(-0.5, 0.5, size=(n, 2))
        pts = np.zeros((n, 3))
        for f in range(5):
            m = faces == f
            if f == 0:   # +x face
                pts[m] = np.stack([np.full(m.sum(), 0.5) * s[0],
                                   u[m, 0] * s[1], u[m, 1] * s[2]], 1)
            elif f == 1:
                pts[m] = np.stack([np.full(m.sum(), -0.5) * s[0],
                                   u[m, 0] * s[1], u[m, 1] * s[2]], 1)
            elif f == 2:
                pts[m] = np.stack([u[m, 0] * s[0],
                                   np.full(m.sum(), 0.5) * s[1],
                                   u[m, 1] * s[2]], 1)
            elif f == 3:
                pts[m] = np.stack([u[m, 0] * s[0],
                                   np.full(m.sum(), -0.5) * s[1],
                                   u[m, 1] * s[2]], 1)
            else:        # top
                pts[m] = np.stack([u[m, 0] * s[0], u[m, 1] * s[1],
                                   np.full(m.sum(), 0.5) * s[2]], 1)
    else:
        pts = rng.uniform(-0.5, 0.5, size=(n, 3)) * s
    return c + pts + rng.normal(scale=noise, size=(n, 3))


@dataclasses.dataclass
class Scene:
    """World-frame static geometry + moving-object trajectories.

    Each object carries its own intensity base (stable across frames):
    real surfaces are internally homogeneous but DIFFER between objects,
    which is exactly the contrast the RI3 intensity refinement exploits
    (reference thresholds: var <= 1.0 within a voxel, mean-diff <= 2.0
    across voxels, config/semantickitti.yaml:53-54). Drawing every car
    from one shared band would let RI3 fuse distinct adjacent cars."""
    buildings: List[Tuple[np.ndarray, np.ndarray]]
    trees: List[np.ndarray]
    parked: List[np.ndarray]
    moving_start: List[np.ndarray]
    moving_vel: List[np.ndarray]
    spec: SceneSpec
    building_int: List[float] = dataclasses.field(default_factory=list)
    parked_int: List[float] = dataclasses.field(default_factory=list)
    moving_int: List[float] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        rng = np.random.default_rng(self.spec.seed + 1234)
        if not self.building_int:
            self.building_int = list(rng.uniform(70, 100,
                                                 len(self.buildings)))
        if not self.parked_int:
            self.parked_int = list(rng.uniform(100, 220, len(self.parked)))
        if not self.moving_int:
            self.moving_int = list(rng.uniform(100, 220,
                                               len(self.moving_start)))


def _moving_center(scene: Scene, i: int, frame: int) -> np.ndarray:
    """World-frame center of moving car `i` at `frame`.

    Line scenes store (start, velocity); loop scenes store (initial
    WORLD angle, lane radius, z) in `moving_start` and the WORLD
    angular speed (rad/frame) in `moving_vel[i][0]`: movers are
    traffic on the ego's circular road. Whenever a mover's angular
    offset from the ego exceeds ~+-110 deg it is outside the curved
    grid's 30 m max range (the reference bypasses such points to its
    static set, src/ssc.cpp:161-172) until it circulates back.
    """
    spec = scene.spec
    if spec.trajectory == "loop":
        a0, lane_r, z = scene.moving_start[i]
        a = a0 + scene.moving_vel[i][0] * frame
        cx, cy = 0.0, spec.loop_radius
        return np.array([cx + lane_r * np.sin(a),
                         cy - lane_r * np.cos(a), z])
    if i == 0 and spec.stop_frame is not None:
        frame = min(frame, spec.stop_frame)
    p = scene.moving_start[i] + scene.moving_vel[i] * frame
    if spec.mover_path == "ego_wrap":
        # wrap the along-road offset from the ego into [-L, L)
        L = spec.extent * 0.9
        ego_x = pose_at(spec, frame)[0, 3]
        p = p.copy()
        p[0] = ego_x + (p[0] - ego_x + L) % (2.0 * L) - L
        return p
    if spec.mover_path == "pingpong":
        # reflect the along-road coordinate into [-L, L] (triangle wave)
        # so movers stay inside the corridor for arbitrarily long windows
        L = spec.extent * 0.9
        p = p.copy()
        p[0] = abs((p[0] + L) % (4.0 * L) - 2.0 * L) - L
    return p


def _make_loop_scene(spec: SceneSpec, rng) -> Scene:
    """Static geometry in a ring around the circular road (center (0, R),
    radius R); movers are traffic on exclusive lanes at R +- 2.

    Layout discipline: the mover lanes keep >= 3 m SURFACE clearance from
    every static object. Anything closer fuses the mover into a static
    cluster via the 3x3x3 CVC neighbourhood / RI3 intensity refine (the
    reference behaves identically for touching objects) and the fused
    footprint exceeds car_square, so the mover is never judged. Parked
    cars sit at R +- (7..9) (>= 3.2 m gap after half-widths), trees at
    R +- (9..11), buildings on the outer ring at R + (13..18) with
    bounded extents.
    """
    R = spec.loop_radius
    cx, cy = 0.0, R

    def ring_pos(dist, a=None):
        if a is None:
            a = rng.uniform(0, 2 * np.pi)
        return np.array([cx + dist * np.sin(a), cy - dist * np.cos(a)])

    buildings = []
    for i in range(spec.n_buildings):
        size = np.array([rng.uniform(5, 9), rng.uniform(4, 7),
                         rng.uniform(6, 10)])
        d = R + rng.uniform(13, 18)
        xy = ring_pos(d)
        buildings.append((np.array([xy[0], xy[1],
                                    -spec.sensor_height + size[2] / 2]),
                          size))
    trees = []
    for i in range(spec.n_trees):
        d = R + rng.uniform(9, 11) if i % 2 == 0 else R - rng.uniform(9, 11)
        xy = ring_pos(d)
        trees.append(np.array([xy[0], xy[1], 2.0 - spec.sensor_height]))
    parked = []
    for i in range(spec.n_parked_cars):
        d = R + rng.uniform(7.0, 9.0) if i % 2 == 0 \
            else R - rng.uniform(7.0, 9.0)
        xy = ring_pos(d)
        parked.append(np.array([xy[0], xy[1], 0.75 - spec.sensor_height]))
    moving_start, moving_vel = [], []
    for i in range(spec.n_moving_cars):
        lane = R + 2.0 if i % 2 == 0 else R - 2.0
        # WORLD angular speed: the verdict lattice compensates ego motion
        # through the poses, so what must exceed a car length per frame is
        # the mover's WORLD displacement (~moving_speed m/frame, the scale
        # of the reference's skip-5 KITTI windows) - not its ego-relative
        # sweep. Even-index movers drive the ego's direction (slowly
        # pulling ahead), odd-index ones are oncoming (sweeping past and
        # circulating back into view).
        omega = (spec.moving_speed / lane) * (1 if i % 2 == 0 else -1)
        a0 = (0.45 if i % 2 == 0 else 0.9) + 0.5 * (i // 2)
        moving_start.append(np.array([a0, lane, 0.75 - spec.sensor_height]))
        moving_vel.append(np.array([omega, 0.0, 0.0]))
    return Scene(buildings, trees, parked, moving_start, moving_vel, spec)


VIEW_MARGIN = 12.0      # render_frame keeps points within extent + this


def tile_shifts(spec: SceneSpec) -> List[float]:
    """x shifts of the line scene's static tiles: [0.0] (the default scene)
    unless spec.path_frames > 0, then one shift of k * 3 * extent for every
    tile [shift - extent, shift + 2 * extent] that meets the x range some
    frame of the path can see."""
    if spec.path_frames <= 0:
        return [0.0]
    E = spec.extent
    reach = E + VIEW_MARGIN
    lo = -reach
    hi = spec.ego_speed * (spec.path_frames - 1) + reach
    k_lo = int(np.floor((lo + E) / (3 * E)))
    k_hi = int(np.ceil((hi - 2 * E) / (3 * E)))
    return [3 * E * k for k in range(k_lo, k_hi + 1)]


def make_scene(spec: SceneSpec | None = None) -> Scene:
    spec = spec or SceneSpec()
    rng = np.random.default_rng(spec.seed)
    if spec.trajectory == "loop":
        return _make_loop_scene(spec, rng)
    E = spec.extent
    buildings, trees, parked = [], [], []
    for shift in tile_shifts(spec):
        for i in range(spec.n_buildings):
            side = 1 if i % 2 == 0 else -1
            size = np.array([rng.uniform(8, 16), rng.uniform(4, 8),
                             rng.uniform(6, 10)])
            # buildings sit ON the ground plane (z = -sensor_height)
            center = np.array([rng.uniform(-E, 2 * E) + shift,
                               side * rng.uniform(E * 0.57, E * 0.85),
                               -spec.sensor_height + size[2] / 2])
            buildings.append((center, size))
        for i in range(spec.n_trees):
            side = 1 if i % 2 == 0 else -1
            trees.append(np.array([rng.uniform(-E, 2 * E) + shift,
                                   side * rng.uniform(E * 0.39, E * 0.5),
                                   2.0 - spec.sensor_height]))
        for i in range(spec.n_parked_cars):
            side = 1 if i % 2 == 0 else -1
            parked.append(np.array([
                rng.uniform(-E * 0.5, 1.5 * E) + 4.0 * i + shift,
                side * rng.uniform(E * 0.196, E * 0.232),
                0.75 - spec.sensor_height]))
    # hard scene: cars flush against building walls (gap ~0.3 m - inside
    # RI3's fusion neighbourhood at the default 0.4 m range resolution)
    for i in range(min(spec.wall_parked_cars, len(buildings))):
        bc, bs = buildings[i]
        toward_road = -np.sign(bc[1]) if bc[1] != 0 else 1.0
        parked.append(np.array([
            bc[0] + rng.uniform(-bs[0] / 4, bs[0] / 4),
            bc[1] + toward_road * (bs[1] / 2 + 0.9 + 0.3),
            0.75 - spec.sensor_height]))
    moving_start, moving_vel = [], []
    for i in range(spec.n_moving_cars):
        lane = 2.0 if i % 2 == 0 else -2.0
        moving_start.append(np.array([rng.uniform(5.0, 15.0), lane,
                                      0.75 - spec.sensor_height]))
        moving_vel.append(np.array(
            [spec.moving_speed * (1.0 if i % 2 == 0 else -1.0), 0.0, 0.0]))
    return Scene(buildings, trees, parked, moving_start, moving_vel, spec)


def render_frame(scene: Scene, frame: int):
    """Render one scan in the sensor frame.

    Returns (xyz [N,3] f32, intensity [N] f32, label [N] int32,
             pose [4,4] f32 world_T_sensor).
    """
    spec = scene.spec
    rng = np.random.default_rng(spec.seed * 7919 + frame)
    pose = pose_at(spec, frame)
    ego = pose[:3, 3].astype(np.float64)
    Rw = pose[:3, :3].astype(np.float64)

    pts, labels, intens = [], [], []

    def world_to_sensor(p):
        return (p - ego) @ Rw           # row-vector form of R^T (p - ego)

    # ground: disc around the ego; points under objects are occluded
    r = np.sqrt(rng.uniform(np.square(2.0), np.square(spec.extent),
                            size=spec.ground_pts))
    th = rng.uniform(0, 2 * np.pi, size=spec.ground_pts)
    gx = r * np.cos(th) + ego[0]
    gy = r * np.sin(th) + ego[1]
    gz = -spec.sensor_height + rng.normal(scale=spec.noise,
                                          size=spec.ground_pts)
    gpts = np.stack([gx, gy, gz], 1)
    occluded = np.zeros(spec.ground_pts, bool)
    footprints = [(c, s) for c, s in scene.buildings]
    car_size_fp = np.array([4.2, 1.8, 1.5])
    for pc in scene.parked:
        footprints.append((pc, car_size_fp))
    for i in range(len(scene.moving_start)):
        footprints.append((_moving_center(scene, i, frame), car_size_fp))
    for c, s in footprints:
        inside = (np.abs(gpts[:, 0] - c[0]) < s[0] / 2 + 0.15) \
            & (np.abs(gpts[:, 1] - c[1]) < s[1] / 2 + 0.15)
        occluded |= inside
    gpts = gpts[~occluded]
    pts.append(world_to_sensor(gpts))
    labels.append(np.full(len(gpts), LABEL_GROUND))
    intens.append(rng.uniform(10, 30, size=len(gpts)))

    for bi, (center, size) in enumerate(scene.buildings):
        p = _box_points(rng, center, size, spec.building_pts, spec.noise)
        pts.append(world_to_sensor(p))
        labels.append(np.full(len(p), LABEL_BUILDING))
        intens.append(scene.building_int[bi]
                      + rng.normal(0, 1.5, size=len(p)))  # homogeneous walls

    for tc in scene.trees:
        # trunk + scattered canopy: high intensity variance; no returns
        # below the ground plane (LiDAR never sees underground)
        canopy = tc + np.clip(rng.normal(size=(spec.tree_pts, 3)),
                              -2.0, 2.0) * [1.2, 1.2, 1.6]
        canopy[:, 2] = np.maximum(canopy[:, 2], -spec.sensor_height + 0.25)
        pts.append(world_to_sensor(canopy))
        labels.append(np.full(spec.tree_pts, LABEL_TREE))
        intens.append(rng.uniform(0, 255, size=spec.tree_pts))

    car_size = np.array([4.2, 1.8, 1.5])
    for ci, pc in enumerate(scene.parked):
        p = _box_points(rng, pc, car_size, spec.car_pts, spec.noise)
        pts.append(world_to_sensor(p))
        labels.append(np.full(len(p), LABEL_CAR_STATIC))
        intens.append(scene.parked_int[ci] + rng.normal(0, 1.5, size=len(p)))

    for i in range(len(scene.moving_start)):
        c = _moving_center(scene, i, frame)
        p = _box_points(rng, c, car_size, spec.car_pts, spec.noise)
        pts.append(world_to_sensor(p))
        # SemanticKITTI's moving-car label is PER SCAN: a car that has
        # stopped is annotated 10 (car), not 252 - so a stopped mover's
        # points are ground-truth STATIC from the stop frame on
        moved = np.linalg.norm(
            _moving_center(scene, i, frame + 1) - c) > 0.05
        labels.append(np.full(len(p), LABEL_CAR_MOVING if moved
                              else LABEL_CAR_STATIC))
        intens.append(scene.moving_int[i] + rng.normal(0, 1.5, size=len(p)))

    xyz = np.concatenate(pts).astype(np.float32)
    label = np.concatenate(labels).astype(np.int32)
    inten = np.concatenate(intens).astype(np.float32)

    # cull to a KITTI-like FOV shell (keeps scan sizes realistic)
    rr = np.hypot(xyz[:, 0], xyz[:, 1])
    keep = (rr > 1.0) & (rr < spec.extent + 12.0)
    return xyz[keep], inten[keep], label[keep], pose


def render_window(scene: Scene, n_frames: int, max_points: int):
    """Render a padded window of frames.

    Returns dict of stacked arrays:
      xyz [F, N, 3], intensity [F, N], label [F, N], valid [F, N],
      poses [F, 4, 4].
    """
    xs, ins, ls, vs, ps = [], [], [], [], []
    for f in range(n_frames):
        xyz, inten, label, pose = render_frame(scene, f)
        if len(xyz) > max_points:
            # unbiased cap: render_frame emits points grouped by object
            # class (movers LAST), so truncating in emission order would
            # silently drop whole classes - shuffle first
            perm = np.random.default_rng(scene.spec.seed * 31 + f
                                         ).permutation(len(xyz))
            xyz, inten, label = xyz[perm], inten[perm], label[perm]
        n = min(len(xyz), max_points)
        X = np.zeros((max_points, 3), np.float32)
        I = np.zeros((max_points,), np.float32)
        L = np.zeros((max_points,), np.int32)
        V = np.zeros((max_points,), bool)
        X[:n] = xyz[:n]
        I[:n] = inten[:n]
        L[:n] = label[:n]
        V[:n] = True
        xs.append(X); ins.append(I); ls.append(L); vs.append(V); ps.append(pose)
    return {
        "xyz": np.stack(xs), "intensity": np.stack(ins),
        "label": np.stack(ls), "valid": np.stack(vs),
        "poses": np.stack(ps),
    }
