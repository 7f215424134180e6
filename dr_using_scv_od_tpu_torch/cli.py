"""Command-line entry points (counterpart of dr_using_scv_od_tpu/cli.py: the
same subcommands, flags, printed lines and files written).

Replaces the reference's executable fleet (CMakeLists.txt:82-173):
  segdf     - the whole batch pipeline (ufo_ufo: main.cpp + SSC::segDF)
  evaluate  - PR/RR/F1 + per-class tables (tool/analysis.py + ufo_evaluate)
  odometry  - GICP pose estimation + ATE (new capability)
  colorize  - KITTI .bin -> PCD (ufo_color, src/colorBin.cpp)

Every subcommand that computes takes `--device` (default `cuda`): the
pipeline, the odometry and the engine run on that device, the label
kernel on the card. With the default and no CUDA GPU visible the command
raises; it never carries on on the CPU. `--device cpu` runs the plain
PyTorch path.

Run `python -m dr_using_scv_od_tpu_torch.cli <cmd> --help`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch


def _device(args) -> torch.device:
    """The device `--device` names; raises when it is a CUDA device and no
    CUDA GPU is visible."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device} needs a CUDA GPU and none is visible; "
            "pass --device cpu to run the plain PyTorch path")
    return dev


def _load_window(args, cfg):
    """(window as tensors on the device, the same window as numpy)."""
    dev = _device(args)
    if args.data == "synthetic":
        from .utils import synthetic
        if getattr(args, "scene", "default") == "tiny":
            spec = synthetic.SceneSpec(
                ground_pts=1500, building_pts=300, tree_pts=100,
                car_pts=120, n_buildings=2, n_trees=3, n_parked_cars=2,
                n_moving_cars=2, extent=14.0, moving_speed=4.0,
                ego_speed=1.0, seed=args.seed)
        elif getattr(args, "scene", "default") == "loop":
            # circular revisit trajectory (128 scans/lap): long-sequence
            # + loop-closure demos, e.g. `slam --scene loop --frames 512
            # --kf-dist 4.0` = 4 laps through a gated keyframe budget
            spec = synthetic.SceneSpec(
                trajectory="loop", loop_frames=128, loop_radius=18.0,
                n_moving_cars=2, seed=args.seed)
        else:
            spec = synthetic.SceneSpec(seed=args.seed)
        if getattr(args, "extent", None):
            spec = dataclasses.replace(spec, extent=args.extent)
        scene = synthetic.make_scene(spec)
        win = synthetic.render_window(scene, args.frames,
                                      cfg.shapes.max_points)
    else:
        from .utils import io_kitti
        tr = np.asarray(json.loads(args.tr)) if args.tr else np.eye(4)
        win = io_kitti.load_window(
            args.data, args.labels, args.poses, tr, args.start, args.end,
            cfg.skip, cfg.shapes.max_points,
            max_intensity=cfg.max_intensity)
    return {k: torch.as_tensor(v, device=dev) for k, v in win.items()}, win


def cmd_segdf(args):
    from . import config
    from .eval import metrics
    from .models import odometry, pipeline
    from .utils import io_kitti, timing

    cfg = getattr(config, args.profile)()
    win_t, win = _load_window(args, cfg)
    timer = timing.StageTimer(Path(args.out) / "time.txt"
                              if args.out else None)

    poses = win_t["poses"]
    if args.estimate_poses:
        with timer.stage("odometry"):
            od = odometry.estimate_window_poses(win_t["xyz"],
                                                win_t["valid"], cfg)
            poses = od.poses
            timing.sync(poses)

    with timer.stage("pipeline"):
        res = pipeline.run_window(win_t["xyz"], win_t["intensity"],
                                  win_t["valid"], poses, cfg)
        removed = res.removed.cpu().numpy()
    timer.end_frame()

    F = win["xyz"].shape[0]
    m = metrics.removal_metrics(win["label"], removed, win["valid"])
    mj = metrics.removal_metrics(win["label"][:F - 1], removed[:F - 1],
                                 win["valid"][:F - 1])
    print(f"frames={F}  PR={m.pr:.2f}  RR={m.rr:.2f}  F1={m.f1:.4f}  "
          f"(judged frames: PR={mj.pr:.2f} RR={mj.rr:.2f} F1={mj.f1:.4f})")
    per_cls = metrics.per_class_rejection(
        np.asarray(win["label"]).reshape(-1), removed.reshape(-1),
        np.asarray(win["valid"]).reshape(-1))
    for c, (rr, remain, total) in sorted(per_cls.items()):
        print(f"  class {c}: RR={rr:.2f}%  remain={remain}/{total}")

    if args.iou:
        # direct pipeline -> per-class IoU against the window's own GT
        # labels (the reference needs the plotObject detour through saved
        # PCD artifacts, src/plotObject.cpp:41-147)
        from .models.segmentation import ROUTE_GROUND
        lut = np.array([50, 70, 10], np.int32)   # building, tree, car
        pc_all = res.point_cluster.cpu().numpy()
        types = res.tables.type.cpu().numpy()
        states = res.tables.state.cpu().numpy()
        routes = res.frames.state.point_route.cpu().numpy()
        F = pc_all.shape[0]
        pred = np.full(pc_all.shape, -1, np.int32)
        for f in range(F):
            pcs = np.clip(pc_all[f], 0, types.shape[1] - 1)
            t = types[f][pcs]
            lab = np.where((pc_all[f] >= 0) & (t >= 0), lut[np.clip(t, 0, 2)],
                           -1)
            lab = np.where((pc_all[f] >= 0) & (states[f][pcs] == 1), 252,
                           lab)
            lab = np.where(routes[f] == ROUTE_GROUND, 40, lab)
            pred[f] = lab
        class_map = {40: (40, 44, 48, 49), 50: (50, 51, 52),
                     70: (70, 71, 72), 10: (10, 13, 16, 18, 20),
                     252: tuple(metrics.DYNAMIC_CLASSES)}
        iou = metrics.semantic_iou(
            np.asarray(win["label"]).reshape(-1), pred.reshape(-1),
            np.asarray(win["valid"]).reshape(-1), class_map)
        for cls, name in [(40, "ground"), (50, "building"), (70, "tree"),
                          (10, "car"), (252, "PD")]:
            print(f"  IoU {name}: {iou[cls]:.2f}%")

    if args.out:
        from .utils import artifacts
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        pc_all = res.point_cluster.cpu().numpy()
        types = res.tables.type.cpu().numpy()
        states = res.tables.state.cpu().numpy()
        tracks = res.tables.track_id.cpu().numpy()
        for f in range(F):
            keep = np.asarray(win["valid"][f]) & ~removed[f]
            xyzi = np.concatenate(
                [np.asarray(win["xyz"][f])[keep],
                 np.asarray(win["intensity"][f])[keep, None]], axis=1)
            io_kitti.write_pcd_xyzi(out / f"{f:06d}_static.pcd", xyzi)
            dyn = np.asarray(win["valid"][f]) & removed[f]
            xyzi_d = np.concatenate(
                [np.asarray(win["xyz"][f])[dyn],
                 np.asarray(win["intensity"][f])[dyn, None]], axis=1)
            io_kitti.write_pcd_xyzi(out / f"{f:06d}_dynamic.pcd", xyzi_d)
            # colored cluster visualization (saveSegCloud analog)
            xyzrgb = artifacts.colored_segmentation(
                np.asarray(win["xyz"][f]), pc_all[f],
                types[f], states[f], tracks[f])
            artifacts.write_colored_pcd(out / f"{f:06d}_seg.pcd", xyzrgb)
        print(f"artifacts -> {out}")
    return 0


def cmd_bench_table(args):
    """Emit the BASELINE.md-shaped parity table: per-sequence profiles x
    {full, -RI3, -TC} x occupancy {0.2, 0.5, 0.8}, plus an 'ours+' row
    with the beyond-reference dynamic-footprint sweep enabled.

    Parity rows run with `dynamic_bbox_sweep` OFF so they measure the
    reference's verdict semantics alone; the extension is reported
    separately. With --data pointing at SemanticKITTI the per-profile
    window (sequence: start/end in the YAML) is used; on synthetic data
    every profile runs the same generated window, so rows differ only by
    the profile's knobs.
    """
    import yaml

    from . import config, config_yaml
    from .eval import metrics

    from .models import pipeline

    profile_paths = sorted(Path(args.profiles).glob("*.yaml"))
    if not profile_paths:
        print(f"no profiles in {args.profiles}", file=sys.stderr)
        return 1

    thresholds = tuple(float(t) for t in args.thresholds.split(","))
    print("| sequence | variant | occupancy | PR | RR | F1 |")
    print("|---|---|---|---|---|---|")

    base = getattr(config, args.profile)()
    for path in profile_paths:
        cfg = config_yaml.load(path, base=base)
        with open(path) as f:
            meta = (yaml.safe_load(f) or {}).get("sequence", {})
        seq = str(meta.get("id", path.stem))
        # per-profile window bounds stay LOCAL: writing back into args would
        # leak one profile's sequence block into the next profile's window
        if args.data != "synthetic" and meta:
            win_args = argparse.Namespace(**vars(args))
            win_args.start = int(meta.get("start", args.start))
            win_args.end = int(meta.get("end", args.end))
        else:
            win_args = args
        win_t, win = _load_window(win_args, cfg)

        def run_variant(cfg_v, label, thr_list):
            for thr in thr_list:
                cfg_t = dataclasses.replace(cfg_v, track=dataclasses.replace(
                    cfg_v.track, occupancy=thr))
                res = pipeline.run_window(
                    win_t["xyz"], win_t["intensity"], win_t["valid"],
                    win_t["poses"], cfg_t)
                F = win_t["xyz"].shape[0]
                m = metrics.removal_metrics(
                    win["label"][:F - 1],
                    res.removed[:F - 1].cpu().numpy(),
                    win["valid"][:F - 1])
                print(f"| {seq} | {label} | {thr:.1f} | {m.pr:.2f} "
                      f"| {m.rr:.2f} | {m.f1:.4f} |", flush=True)

        parity = dataclasses.replace(cfg, track=dataclasses.replace(
            cfg.track, dynamic_bbox_sweep=False))
        run_variant(parity, "full", thresholds)
        run_variant(
            dataclasses.replace(parity, seg=dataclasses.replace(
                parity.seg, iteration=0)),
            "-RI3", (cfg.track.occupancy,))
        run_variant(
            dataclasses.replace(parity, track=dataclasses.replace(
                parity.track, enable_compensation=False)),
            "-TC", (cfg.track.occupancy,))
        run_variant(cfg, "ours+sweep", (cfg.track.occupancy,))
    return 0


def stream_scans(args, cfg):
    """The `--data <dir>` scan stream of `slam`: (iterator of padded
    (xyz [N,3] f32, intensity [N] f32, valid [N] bool) numpy scans decoded
    ahead by utils/prefetch.ScanPrefetcher, number of scans). The engine
    uploads each scan to its device as it is fed."""
    from .utils import io_kitti
    from .utils.prefetch import ScanPrefetcher
    bins = io_kitti.sorted_frame_files(args.data, ".bin")
    labs = (io_kitti.sorted_frame_files(args.labels, ".label")
            if args.labels else None)
    end = args.end if args.end > 0 else len(bins)
    sel = list(range(args.start, min(end, len(bins)), cfg.skip))
    pf = ScanPrefetcher(
        [bins[i] for i in sel],
        [labs[i] for i in sel] if labs else None,
        max_points=cfg.shapes.max_points * 4,
        max_intensity=cfg.max_intensity)

    def scans():
        N = cfg.shapes.max_points
        for xyz, inten, _lab in pf:
            keep = io_kitti._voxel_downsample_np(xyz, 0.08)
            xyz, inten = xyz[keep], inten[keep]
            n = min(len(xyz), N)
            X = np.zeros((N, 3), np.float32)
            I = np.zeros((N,), np.float32)
            V = np.zeros((N,), bool)
            X[:n], I[:n], V[:n] = xyz[:n], inten[:n], True
            yield X, I, V

    return scans(), len(sel)


def cmd_slam(args):
    """Streaming odometry+mapping engine over a scan sequence: GICP
    scan-to-map odometry -> segmentation/tracking -> keyframe submaps ->
    descriptor loop closure -> pose-graph solve -> periodic ERASOR +
    checkpoints (models/engine.py; the composed loop the reference left
    commented out at src/ssc.cpp:1454-1546)."""
    from . import config
    from .models import engine, odometry
    from .utils import io_kitti

    cfg = getattr(config, args.profile)()
    dev = _device(args)
    if args.data == "synthetic":
        _, win = _load_window(args, cfg)
        scan_iter = None
        F = win["xyz"].shape[0]
    else:
        # STREAMING dataset path: scans decode in a background thread
        # (utils/prefetch.ScanPrefetcher -> native prefetch_open ring)
        # and feed the engine one at a time - constant memory over
        # arbitrarily long sequences, IO overlapped with device compute
        # (the reference decodes synchronously inside its frame loop,
        # src/ssc.cpp:1046-1058).
        win = None
        scan_iter, F = stream_scans(args, cfg)
    ec = engine.EngineConfig(
        window=args.window, max_keyframes=args.max_keyframes,
        submap_points=args.submap_points,
        kf_dist=args.kf_dist, kf_rot=args.kf_rot,
        loop_min_score=args.loop_min_score,
        max_loop_edges=args.max_loop_edges,
        erasor=dataclasses.replace(engine.erasor_mod.ErasorConfig(),
                           max_range=args.erasor_max_range,
                           max_pts_per_bin=args.erasor_max_pts),
        erasor_every=args.erasor_every,
        drift_bias=tuple(json.loads(args.drift_bias)) if args.drift_bias
        else (0.0,) * 6)

    if args.resume:
        eng = engine.SlamEngine.resume(args.resume, cfg, ec,
                                       ckpt_dir=args.out,
                                       ckpt_every=args.ckpt_every,
                                       device=dev)
        start = eng.n_frames
        print(f"resumed at frame {start} from {args.resume}")
    else:
        eng = engine.SlamEngine(cfg, ec, ckpt_dir=args.out,
                                ckpt_every=args.ckpt_every, device=dev)
        start = 0

    n_dyn = 0

    def frame_source():
        if scan_iter is not None:
            for f, scan in enumerate(scan_iter):
                if f >= start:
                    yield scan
        else:
            for f in range(start, F):
                yield (win["xyz"][f], win["intensity"][f], win["valid"][f])

    for scan in frame_source():
        out = eng.feed(*scan)
        if out is not None:
            n_dyn += int(np.sum(out.n_dynamic))
            for r in np.flatnonzero(np.asarray(out.loop_accepted)):
                i, j = (int(v) for v in out.loop_pair[r])
                print(f"  loop closed: kf {i} <- {j} "
                      f"(score {float(out.loop_score[r]):.3f}, "
                      f"rmse {float(out.loop_rmse[r]):.3f})")
    eng.finalize()

    poses = eng.poses()
    st = eng.state
    print(f"frames={eng.n_frames}  keyframes={eng.n_keyframes}  "
          f"loops={int(st.n_loops)}  "
          f"dynamic_clusters={n_dyn}  "
          f"erasor_removed={int(st.erasor_removed)}  "
          f"odo_fallbacks={int(st.odo_fallbacks)}")
    if win is not None and "poses" in win:
        # compare each KEYFRAME's pose against the GT pose of the scan
        # that created it (with gating off, keyframes == scans)
        gt = torch.as_tensor(win["poses"][eng.kf_frames()], device=dev)
        ate = float(odometry.ate_rmse(torch.as_tensor(poses, device=dev),
                                      gt))
        print(f"ATE={ate:.3f} m")
    if args.out:
        outdir = Path(args.out)
        outdir.mkdir(parents=True, exist_ok=True)
        m = eng.static_map()
        io_kitti.write_pcd_xyzi(
            outdir / "map_static.pcd",
            np.concatenate([m, np.zeros((len(m), 1), np.float32)], axis=1))
        np.savetxt(outdir / "trajectory.txt",
                   poses[:, :3, :].reshape(len(poses), 12), fmt="%.6f")
        print(f"map ({len(m)} pts) + trajectory -> {outdir}")
    return 0


def cmd_odometry(args):
    from . import config
    from .models import odometry

    cfg = getattr(config, args.profile)()
    win_t, win = _load_window(args, cfg)
    od = odometry.estimate_window_poses(win_t["xyz"], win_t["valid"], cfg)
    ate = float(odometry.ate_rmse(od.poses, win_t["poses"]))
    print(f"frames={win['xyz'].shape[0]}  ATE_rmse={ate:.4f} m")
    for f, (nc, err) in enumerate(zip(od.n_corr.cpu().numpy(),
                                      od.final_error.cpu().numpy())):
        print(f"  pair {f}->{f+1}: corr={int(nc)} err={float(err):.5f}")
    if args.out:
        np.savetxt(args.out,
                   od.poses.cpu().numpy()[:, :3, :].reshape(-1, 12))
        print(f"poses -> {args.out}")
    return 0


def cmd_evaluate(args):
    """PR/RR from saved static/dynamic artifact PCDs vs a labeled window
    (artifact-level twin of tool/analysis.py)."""
    from .eval import artifact as artifact_eval
    _device(args)
    return artifact_eval.evaluate_cli(args)


def cmd_evaluate_map(args):
    """4-outcome (TP/FN/TN/FP) recolored evaluation cloud
    (ufo_evaluate, src/evaluate.cpp:79-145)."""
    from .eval import artifact as artifact_eval
    _device(args)
    return artifact_eval.evaluate_map_cli(args)


def cmd_colorize(args):
    from .utils import io_kitti
    pts = io_kitti.read_bin(args.bin)
    io_kitti.write_pcd_xyzi(args.out, pts)
    print(f"{len(pts)} pts -> {args.out}")
    return 0


def cmd_erasor(args):
    """Clean an accumulated map against a scan (models/erasor.py; the
    reference only *compares* against ERASOR via src/erasor_dynamic.cpp)."""
    from .models import erasor
    from .utils import io_kitti

    dev = _device(args)
    m = io_kitti.read_pcd_xyzi(args.map)
    s = io_kitti.read_pcd_xyzi(args.scan)
    ego = np.asarray(json.loads(args.ego), np.float32) if args.ego \
        else np.zeros(3, np.float32)
    res = erasor.clean_map(
        torch.as_tensor(m[:, :3], device=dev),
        torch.ones(len(m), dtype=torch.bool, device=dev),
        torch.as_tensor(s[:, :3], device=dev),
        torch.ones(len(s), dtype=torch.bool, device=dev),
        torch.as_tensor(ego, device=dev), erasor.ErasorConfig())
    dyn = res.dynamic.cpu().numpy()
    io_kitti.write_pcd_xyzi(args.out_static, m[~dyn])
    io_kitti.write_pcd_xyzi(args.out_dynamic, m[dyn])
    print(f"map {len(m)} pts: static {int((~dyn).sum())}, "
          f"dynamic {int(dyn.sum())} "
          f"(candidate bins {int(res.candidate_bins.sum())})")
    return 0


def cmd_iou(args):
    """Per-class semantic IoU of a classified map vs GT labels
    (src/plotObject.cpp analog)."""
    from .eval import metrics as metrics_mod
    from .utils import io_kitti

    gt = io_kitti.read_pcd_xyzi(args.gt)
    est = io_kitti.read_pcd_xyzi(args.est)
    assert len(gt) == len(est), "gt/est must be point-aligned"
    class_map = {0: (50, 51, 52), 1: (70, 71, 72), 2: (10, 252)}
    res = metrics_mod.semantic_iou(gt[:, 3].astype(np.uint32),
                                   est[:, 3].astype(np.int32),
                                   np.ones(len(gt), bool), class_map)
    for cls, name in [(0, "building"), (1, "tree"), (2, "car/PD")]:
        print(f"  {name}: IoU={res[cls]:.2f}%")
    return 0


def cmd_remain(args):
    """Recolor an estimated static map by GT dynamic labels: remaining
    dynamic points red, static grey (ufo_remain, src/plotStatic.cpp)."""
    from .utils import artifacts, io_kitti

    m = io_kitti.read_pcd_xyzi(args.map)
    xyzrgb = artifacts.remain_map(m[:, :3], m[:, 3].astype(np.uint32))
    n_dyn = int((xyzrgb[:, 3] == 255).sum())
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    artifacts.write_colored_pcd(out, xyzrgb)
    print(f"{len(m)} pts, {n_dyn} remaining dynamic -> {out}")
    return 0


def cmd_merge(args):
    """Merge consecutive (ground, nonground) PCD pairs back into single
    XYZI scans (the reference's misnamed src/gicp.cpp:15-57)."""
    from .utils import io_kitti

    files = io_kitti.sorted_frame_files(args.dir, ".pcd")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    count = 0
    for i in range(0, len(files) - 1, 2):
        a = io_kitti.read_pcd_xyzi(files[i])
        b = io_kitti.read_pcd_xyzi(files[i + 1])
        merged = np.concatenate([a, b], axis=0)
        merged[:, 3] = 0.0
        io_kitti.write_pcd_xyzi(out / f"{count}.pcd", merged)
        count += 1
    print(f"{count} merged scans -> {out}")
    return 0


def cmd_pcd2bin(args):
    """PCD dir -> KITTI .bin dir (tool/pcd2bin.py analog)."""
    from .utils import io_kitti

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    files = io_kitti.sorted_frame_files(args.pcd, ".pcd")
    for p in files:
        xyzi = io_kitti.read_pcd_xyzi(p)
        xyzi.astype(np.float32).tofile(out / f"{p.stem}.bin")
    print(f"{len(files)} scans -> {out}")
    return 0


def cmd_sydney(args):
    """Sydney Urban Objects .bin -> PCD (tool/car.py analog)."""
    from .utils import io_kitti, io_sydney

    xyzi = io_sydney.sydney_to_xyzi(args.bin)
    io_kitti.write_pcd_xyzi(args.out, xyzi)
    print(f"{len(xyzi)} pts -> {args.out}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="dr_using_scv_od_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on; 'cuda' (the default) "
                             "raises without a CUDA GPU, 'cpu' runs the "
                             "plain PyTorch path")

    def common(sp):
        device(sp)
        sp.add_argument("--profile", default="semantickitti",
                        choices=["semantickitti", "parkinglot", "tiny_test"])
        sp.add_argument("--data", default="synthetic",
                        help="'synthetic' or a KITTI velodyne dir")
        sp.add_argument("--labels", default=None)
        sp.add_argument("--poses", default=None)
        sp.add_argument("--tr", default=None, help="json 4x4 calibration")
        sp.add_argument("--start", type=int, default=0)
        sp.add_argument("--end", type=int, default=50)
        sp.add_argument("--frames", type=int, default=6,
                        help="synthetic window length")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--extent", type=float, default=None,
                        help="synthetic scene half-extent (m)")
        sp.add_argument("--scene", default="default",
                        choices=["default", "tiny", "loop"],
                        help="synthetic scene preset (loop = circular "
                             "revisit trajectory, 128 scans/lap)")
        sp.add_argument("--out", default=None)

    sp = sub.add_parser("segdf", help="full dynamic-removal pipeline")
    common(sp)
    sp.add_argument("--estimate-poses", action="store_true")
    sp.add_argument("--iou", action="store_true",
                    help="also report per-class semantic IoU vs GT labels")
    sp.set_defaults(fn=cmd_segdf)

    sp = sub.add_parser("odometry", help="GICP window odometry + ATE")
    common(sp)
    sp.set_defaults(fn=cmd_odometry)

    sp = sub.add_parser(
        "bench-table",
        help="BASELINE.md-shaped parity table: profiles x ablations x "
             "occupancy sweep")
    common(sp)
    sp.add_argument("--profiles", default="configs",
                    help="directory of per-sequence YAML profiles")
    sp.add_argument("--thresholds", default="0.2,0.5,0.8",
                    help="comma-separated occupancy thresholds")
    sp.set_defaults(fn=cmd_bench_table)

    sp = sub.add_parser(
        "slam", help="streaming odometry+mapping engine (no GT poses)")
    common(sp)
    sp.add_argument("--window", type=int, default=6)
    sp.add_argument("--max-keyframes", type=int, default=128)
    sp.add_argument("--submap-points", type=int, default=4096)
    sp.add_argument("--kf-dist", type=float, default=0.0,
                    help="keyframe distance gate in metres (0=every scan "
                         "is a keyframe)")
    sp.add_argument("--kf-rot", type=float, default=0.0,
                    help="keyframe rotation gate in radians (0=off)")
    sp.add_argument("--loop-min-score", type=float, default=0.92,
                    help="descriptor similarity floor for loop proposal")
    sp.add_argument("--max-loop-edges", type=int, default=32)
    sp.add_argument("--erasor-max-range", type=float, default=60.0)
    sp.add_argument("--erasor-max-pts", type=int, default=1024)
    sp.add_argument("--erasor-every", type=int, default=4,
                    help="windows between ERASOR map cleanings (0=final)")
    sp.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every N frames (0=off; needs --out)")
    sp.add_argument("--resume", default=None,
                    help="checkpoint path to resume from")
    sp.add_argument("--drift-bias", default=None,
                    help="JSON [6] se(3) odometry bias (fault injection)")
    sp.set_defaults(fn=cmd_slam)

    sp = sub.add_parser("evaluate", help="metrics from artifact PCDs")
    sp.add_argument("--gt", required=True, help="labeled gt pcd")
    sp.add_argument("--est", required=True, help="estimated static pcd")
    sp.add_argument("--voxel", type=float, default=0.2)
    device(sp)
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser(
        "evaluate-map",
        help="TP/FN/TN/FP recolored evaluation cloud (ufo_evaluate)")
    sp.add_argument("--gt", required=True, help="labeled gt pcd")
    sp.add_argument("--static", required=True, help="estimated static pcd")
    sp.add_argument("--dynamic", required=True, help="estimated dynamic pcd")
    sp.add_argument("--out", required=True, help="output evaluate.pcd")
    sp.add_argument("--radius", type=float, default=0.15,
                    help="primary match radius (evaluate.cpp:97)")
    sp.add_argument("--radius2", type=float, default=0.1,
                    help="secondary (cross) match radius (evaluate.cpp:108)")
    device(sp)
    sp.set_defaults(fn=cmd_evaluate_map)

    sp = sub.add_parser("colorize", help="KITTI .bin -> PCD")
    sp.add_argument("--bin", required=True)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_colorize)

    sp = sub.add_parser("erasor", help="ERASOR-style map cleaning")
    sp.add_argument("--map", required=True)
    sp.add_argument("--scan", required=True)
    sp.add_argument("--ego", default=None, help="json [x,y,z]")
    sp.add_argument("--out-static", default="static.pcd")
    sp.add_argument("--out-dynamic", default="dynamic.pcd")
    device(sp)
    sp.set_defaults(fn=cmd_erasor)

    sp = sub.add_parser("iou", help="per-class semantic IoU")
    sp.add_argument("--gt", required=True)
    sp.add_argument("--est", required=True)
    sp.set_defaults(fn=cmd_iou)

    sp = sub.add_parser("remain",
                        help="recolor static map by GT dynamic labels")
    sp.add_argument("--map", required=True, help="labeled static-map pcd")
    sp.add_argument("--out", default="remain.pcd")
    sp.set_defaults(fn=cmd_remain)

    sp = sub.add_parser("merge",
                        help="merge ground/nonground PCD pairs to scans")
    sp.add_argument("--dir", required=True)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_merge)

    sp = sub.add_parser("pcd2bin", help="PCD dir -> KITTI .bin dir")
    sp.add_argument("--pcd", required=True)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_pcd2bin)

    sp = sub.add_parser("sydney", help="Sydney objects .bin -> PCD")
    sp.add_argument("--bin", required=True)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_sydney)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
