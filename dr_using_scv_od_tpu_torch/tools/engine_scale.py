"""The SLAM engine over a sequence several times its keyframe budget, and
its two short guards, on the device the caller names (the scenarios of
the JAX package's tests/test_engine_scale.py):

  * the long run: 96 scans, two laps of a 48-frame loop of radius 18 m
    with two moving cars, through K = 28 keyframe slots behind a 10 m
    distance gate, with injected odometry drift. `floors` reads what that
    file holds: no keyframe dropped, keyframes spanning the run, loop
    edges from several queries, the pose graph's ATE against the chained
    odometry's, submaps topped up by non-keyframe scans, and the map's
    moving-car contamination;
  * the budget case: without gating, 12 scans overrun K = 8, the engine
    raises its keyframe-budget error and keeps the 8 keyframes it has;
  * the false-positive case: a loop candidate whose descriptor is the
    query's own and whose submap is noise far away must fail the GICP
    verification.

`tiny_cfg` is the JAX file's (N = 8,192 points, C = 256, a 2.4 x 4.0
degree grid, GICP extent 48 m); `chip_smoke.py` phase 15 also runs the
long run at full `semantickitti()` width.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import config
from ..models import engine, odometry, posegraph, scan_context
from ..utils import synthetic

F_LONG = 96            # two laps of the 48-frame loop
ATE_FLOOR = 7.0        # m, set for tiny_cfg (tests/test_engine_scale.py:102)
MAP_POINTS_FLOOR = 10000
CONTAMINATION_FLOOR = 1.0     # % of the map's points on moving cars


def tiny_cfg() -> config.PipelineConfig:
    cfg = config.semantickitti()
    return cfg.replace(
        grid=dataclasses.replace(cfg.grid, sector_res=2.4, azimuth_res=4.0),
        shapes=dataclasses.replace(cfg.shapes, max_points=8192,
                                   max_clusters=256, max_track_points=2048),
        gicp=dataclasses.replace(cfg.gicp, xy_extent=48.0))


def long_run_config() -> engine.EngineConfig:
    return engine.EngineConfig(
        window=6, max_keyframes=28, submap_points=2048, local_map_kf=3,
        kf_dist=10.0, loop_min_gap=6, loop_min_score=0.80, loop_top_k=3,
        erasor=dataclasses.replace(engine.erasor_mod.ErasorConfig(),
                                   max_range=45.0, max_pts_per_bin=256),
        erasor_every=2, drift_bias=(0.05, 0.0, 0.0, 0.0, 0.0, 0.004))


def long_run_window(n_points: int) -> dict:
    spec = synthetic.SceneSpec(
        trajectory="loop", loop_frames=48, loop_radius=18.0,
        ground_pts=6000, building_pts=800, tree_pts=200, car_pts=250,
        n_moving_cars=2)
    return synthetic.render_window(synthetic.make_scene(spec), F_LONG,
                                   n_points)


def floors(eng: engine.SlamEngine, win: dict) -> dict:
    """The numbers tests/test_engine_scale.py holds, from a finalized
    engine and the window it was fed."""
    st = eng.state
    n_kf = eng.n_keyframes
    kf = eng.kf_frames()
    nl = int(st.n_loops)
    li = st.loop_i[:nl].cpu().numpy()
    lj = st.loop_j[:nl].cpu().numpy()
    gt = torch.from_numpy(win["poses"][kf])
    ate = float(odometry.ate_rmse(torch.from_numpy(eng.poses()), gt))
    chain = posegraph.odometry_chain(st.rel_T[1:n_kf].cpu())
    sval = st.submap_valid[:n_kf].cpu().numpy()
    sidx = st.submap_idx[:n_kf].cpu().numpy()
    sfrm = st.submap_frame[:n_kf].cpu().numpy()
    n_map = n_dyn = 0
    for k in range(n_kf - 1):
        sel = sval[k] & (sidx[k] >= 0) & (sfrm[k] >= 0)
        lab = win["label"][sfrm[k][sel], sidx[k][sel]]
        n_map += int(sel.sum())
        n_dyn += int((lab == synthetic.LABEL_CAR_MOVING).sum())
    return {
        "n_frames": eng.n_frames, "n_keyframes": n_kf,
        "kf_overflow": int(st.kf_overflow),
        "first_kf": int(kf[0]), "last_kf": int(kf[-1]),
        "kf_increasing": bool(np.all(np.diff(kf) > 0)),
        "n_loops": nl, "loop_queries": len(np.unique(lj)),
        "min_loop_gap": int((lj - li).min()) if nl else 0,
        "ate_pgo": ate, "ate_chain": float(odometry.ate_rmse(chain, gt)),
        "map_frames": len(np.unique(sfrm[sval])),
        "min_fill": int(st.submap_fill[:n_kf - 1].min()),
        "map_points": n_map,
        "contamination": 100.0 * n_dyn / max(n_map, 1),
    }


def missed_floors(fl: dict, ec: engine.EngineConfig,
                  ate_floor: Optional[float] = ATE_FLOOR) -> list:
    """The floors of tests/test_engine_scale.py that `fl` misses (none:
    []). `ate_floor=None` leaves out the absolute ATE floor."""
    checks = {
        "no keyframe dropped": fl["kf_overflow"] == 0,
        f"{F_LONG} frames": fl["n_frames"] == F_LONG,
        "keyframes within the budget": fl["n_keyframes"] <= ec.max_keyframes,
        "frames >= 4 x keyframes": fl["n_frames"] >= 4 * fl["n_keyframes"],
        "keyframes span the run": (fl["first_kf"] == 0 and fl["kf_increasing"]
                                   and fl["last_kf"] >= F_LONG - 8),
        ">= 2 loop edges": fl["n_loops"] >= 2,
        "loop edges from >= 2 queries": fl["loop_queries"] >= 2,
        "loop gaps >= loop_min_gap": fl["min_loop_gap"] >= ec.loop_min_gap,
        "pose graph ATE < 0.8 x chained": fl["ate_pgo"] < 0.8 * fl["ate_chain"],
        "submaps topped up": (fl["map_frames"] > fl["n_keyframes"]
                              and fl["min_fill"] > 0),
        f"> {MAP_POINTS_FLOOR} map points": fl["map_points"] > MAP_POINTS_FLOOR,
        f"contamination < {CONTAMINATION_FLOOR} %":
            fl["contamination"] < CONTAMINATION_FLOOR,
    }
    if ate_floor is not None:
        checks[f"ATE < {ate_floor} m"] = fl["ate_pgo"] < ate_floor
    return [name for name, ok in checks.items() if not ok]


def budget_case(device: torch.device | str):
    """Without gating, 12 scans through K = 8: (the error's text, or None
    if nothing raised, and the kf_frame table [8] after it)."""
    cfg = tiny_cfg()
    scene = synthetic.make_scene(synthetic.SceneSpec(
        ground_pts=4000, building_pts=400, tree_pts=100, car_pts=100,
        n_moving_cars=0))
    win = synthetic.render_window(scene, 12, cfg.shapes.max_points)
    ec = engine.EngineConfig(window=6, max_keyframes=8, submap_points=1024)
    eng = engine.SlamEngine(cfg, ec, device=device)
    err = None
    try:
        for f in range(12):
            eng.feed(win["xyz"][f], win["intensity"][f], win["valid"][f])
    except ValueError as e:
        err = str(e)
    return err, eng.state.kf_frame.cpu().numpy()


def false_positive_noise(seed: int = 0, n: int = 1024) -> np.ndarray:
    """[n, 3] float32 points uniform in [200, 260) m: a submap that no scan
    of the scene can register against."""
    rng = np.random.default_rng(seed)
    return rng.uniform(200.0, 260.0, (n, 3)).astype(np.float32)


def false_positive_case(device: torch.device | str, noise: np.ndarray,
                        query: int = 5) -> dict:
    """Six scans, then keyframe slot 1 poisoned with the query scan's own
    descriptor and `noise` as its submap; only the query proposes. Returns
    the loop step's scores, accepted flags and pairs, and the loop edges it
    added ((i, j) slots)."""
    cfg = tiny_cfg()
    scene = synthetic.make_scene(synthetic.SceneSpec(
        ground_pts=6000, building_pts=800, tree_pts=200, car_pts=200,
        n_moving_cars=0))
    F = 6
    win = synthetic.render_window(scene, F, cfg.shapes.max_points)
    ec = engine.EngineConfig(window=6, max_keyframes=32, submap_points=1024,
                             loop_min_gap=2, loop_min_score=0.9)
    eng = engine.SlamEngine(cfg, ec, device=device)
    for f in range(F):
        eng.feed(win["xyz"][f], win["intensity"][f], win["valid"][f])
    st = eng.state
    desc, sxyz, sval = (st.desc.clone(), st.submap_xyz.clone(),
                        st.submap_valid.clone())
    desc[1] = st.desc[query]
    sxyz[1] = torch.as_tensor(noise, device=sxyz.device)
    sval[1] = True
    st = st.replace(desc=desc, submap_xyz=sxyz, submap_valid=sval)
    xyz = torch.as_tensor(win["xyz"], device=device)
    valid = torch.as_tensor(win["valid"], device=device)
    descs = torch.stack([scan_context.descriptor(xyz[f], valid[f], ec.desc)
                         for f in range(F)])
    slots = torch.arange(F, dtype=torch.int32, device=device)
    is_kf = torch.arange(F, device=device) == query
    (li, lj, _, _, nl), accepted, pairs, diag = engine._window_loops(
        st, xyz, valid, descs, slots, is_kf, True, ec, cfg)
    n0 = int(eng.state.n_loops)
    return {"scores": diag[0].cpu().numpy(),
            "accepted": accepted.cpu().numpy(),
            "pairs": pairs.cpu().numpy(),
            "n_loops_before": n0, "n_loops": int(nl),
            "new_edges": np.stack([li.cpu().numpy()[n0:int(nl)],
                                   lj.cpu().numpy()[n0:int(nl)]], 1)}
