"""Benchmark of the port (counterpart of bench.py): the full dynamic-removal
pipeline's time per frame on one CUDA card, then its stages, odometry and
the streaming SLAM engine, measured at the sizes bench.py measures them.

    python -m dr_using_scv_od_tpu_torch.tools.bench
    python -m dr_using_scv_od_tpu_torch.tools.bench --device cpu \
        --profile tiny_test --reps 1 --frames 3 --slam-frames 36

stdout is ONE JSON line: {"metric": "dynamic_removal_ms_per_frame",
"value", "unit": "ms/frame", "vs_baseline": BASELINE_MS / value,
"device"}, `device` being torch.cuda.get_device_name or "cpu". Everything
else goes to stderr, under bench.py's prefixes:
  [device]          the card's name and power limit (nvidia-smi), or cpu
  [stages ms/frame] estimate_ground, segment_frame, recognize (the point
                    form, recognition.recognize_points) and track_window
                    divided by F, each timed as its own rep loop. bench.py
                    hands its recognize the segment stage's planar counts,
                    which leaves it the feature arithmetic; the point form
                    counts them from the points, work that run_window
                    does not do, so the stages may sum past the headline
  [roofline]        per stage "not measured": PyTorch has no cost model,
                    and bench.py's TPU peaks do not apply. In their place
                    kernel 1 (cluster_labels) on the segment stage's grid:
                    its device time (a CUDA graph of `reps` calls) against
                    its bound, the bytes of tools/kernel_times.bound_bytes
                    over 3.35 TB/s, with the card's power limit. bench.py's
                    hand check of patchwork's one-hot matmul flops is left
                    out: the port sums patches with segment sums
  [trace]           each stage's device ms per frame (torch.profiler over
                    its rep loop, tools/kernel_times.device_ms) beside its
                    wall ms, and the difference (host and dispatch)
  [odometry]        estimate_window_poses ms per pair over F - 1 pairs; one
                    register_pyramid pair
  [slam]            SlamEngine on bench.py's loop scene and EngineConfig:
                    synchronous windows until PIPE_FROM (each (first,
                    erasor) variant's first window left out), then depth-1
                    pipelined windows synced one window behind through
                    pgo_error; ATE, loop edges, odometry fallbacks
  [engine-trace]    device ms of one steady, non-ERASOR engine step from a
                    snapshot of the state, and of its odometry, loops, pose
                    graph and ERASOR parts, each on its own
  [kernels]         cluster_labels launches per section (the wrapper's
                    count; 0 on the CPU, where no kernel launches)

Each timed call runs once as a warm-up, then `reps` times between two CUDA
events, its inputs already on the card (the host clock on the CPU).
PyTorch runs eagerly and hoists nothing out of a loop, so bench.py's
perturbed carry is not needed.

Where this departs from bench.py: no section swallows its failure (an
error in any section ends the run with a non-zero exit and no headline);
the default device is the card, which must exist (the run raises before
any work otherwise); `--device cpu` runs the plain versions only when
asked, and labels every number `cpu`, with no device time. The port's
window step reads the host to propose, accept and count loops, so its
"pipelined" windows cannot run far ahead of the device: both engine
numbers are printed, and the gap between them is what that costs.

The arguments only shrink the run (for the CPU tests); their defaults are
bench.py's constants.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import torch

from .. import config, interop
from ..models import (engine, gicp, odometry, patchwork, pipeline,
                      recognition, scan_context, segmentation, tracking)
from ..ops import cluster_labels
from ..utils import synthetic
from . import kernel_times
from .profile_stages import require_device

REPS = 12           # timed calls per measurement (bench.py:31)
BASELINE_MS = 213.67    # the reference C++ pipeline, SemanticKITTI seq 00
F = 6               # frames of the headline window (bench.py:140)
SLAM_FRAMES = 71    # the [slam] sequence: 14 windows of 6 (bench.py:313)
PIPE_FROM = 7       # first depth-1 pipelined window (bench.py:349)


def slam_spec() -> synthetic.SceneSpec:
    """bench.py's [slam] scene (bench.py:309-312): a 24-frame circle of
    radius 18 m, two moving cars."""
    return synthetic.SceneSpec(trajectory="loop", loop_frames=24,
                               loop_radius=18.0, n_moving_cars=2)


def slam_config() -> engine.EngineConfig:
    """bench.py's [slam] EngineConfig (bench.py:323-329): every scan of the
    loop scene keyframes (kf_dist 4 m < its 4.7 m step) through the gated
    path, periodic ERASOR."""
    return engine.EngineConfig(
        window=6, max_keyframes=128, submap_points=4096, local_map_kf=3,
        kf_dist=4.0, loop_min_gap=8, loop_min_score=0.84, max_loop_edges=32,
        erasor=dataclasses.replace(engine.erasor_mod.ErasorConfig(),
                                   max_range=45.0, max_pts_per_bin=256),
        erasor_every=4)


def time_ms(fn: Callable[[], object], reps: int,
            device: torch.device) -> float:
    """ms per call of fn(): one warm-up call, then `reps` calls between two
    CUDA events (kernel_times.wall_ms; the host clock on the CPU)."""
    if device.type == "cuda":
        return kernel_times.wall_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def busy_ms(fn: Callable[[], object], reps: int,
            device: torch.device) -> Optional[float]:
    """Device ms per call of fn() (torch.profiler over `reps` calls after a
    warm-up; kernel_times.device_ms). On the CPU the calls run the same way
    and the result is None: there is no device time to read."""
    if device.type == "cuda":
        return kernel_times.device_ms(fn, reps)[0]
    for _ in range(reps + 1):
        fn()
    return None


def engine_step_parts(state: engine.EngineState, before, xyz, intensity,
                      valid, ec: engine.EngineConfig, cfg,
                      device: torch.device) -> Dict[str, Optional[float]]:
    """Device ms (busy_ms: one profiled call after a warm-up; None on the
    CPU) of one steady, non-ERASOR engine step from `state` over the window
    `xyz`, `intensity`, `valid` ([W, ...], scan 0 the previous window's
    last), and of its odometry, loops, pose graph and ERASOR parts, each
    on its own. `before` holds clones of the state's leaves, taken when the
    state was current: raises if anything wrote into its tensors since."""
    W = xyz.shape[0]

    def loops():
        descs = torch.stack([scan_context.descriptor(xyz[f], valid[f],
                                                     ec.desc)
                             for f in range(W)])
        slots = state.n - 1 + torch.arange(W, dtype=torch.int32,
                                           device=device)
        return engine._window_loops(
            state, xyz, valid, descs, slots,
            torch.ones(W, dtype=torch.bool, device=device), False, ec, cfg)

    parts = {
        "step": lambda: engine.process_window(state, xyz, intensity, valid,
                                              False, False, ec, cfg),
        "odometry": lambda: engine._window_odometry(state, xyz, valid,
                                                    False, ec, cfg),
        "loops": loops,
        "pgo": lambda: engine._run_pgo(state, state.n, ec),
        "erasor": lambda: engine._erasor_pass(state, xyz[-1], valid[-1],
                                              state.last_pose, ec),
    }
    dev = {name: busy_ms(fn, 1, device) for name, fn in parts.items()}
    for old, now in zip(before, engine.state_leaves(state)):
        if not torch.equal(old, now):
            raise RuntimeError("[engine-trace] a call wrote into the "
                               "snapshot's state")
    return dev


def _fmt(ms: Optional[float]) -> str:
    return "not measured (cpu)" if ms is None else f"{ms:7.2f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--profile", default="semantickitti",
                    choices=["semantickitti", "parkinglot", "tiny_test"])
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--frames", type=int, default=F,
                    help="frames of the headline window (>= 2)")
    ap.add_argument("--slam-frames", type=int, default=SLAM_FRAMES)
    args = ap.parse_args(argv)
    if args.reps < 1 or args.frames < 2:
        ap.error("--reps must be >= 1 and --frames >= 2")
    device = require_device(args.device)

    def err(*a):
        print(*a, file=sys.stderr, flush=True)

    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    else:
        kind = smi = "cpu"
    err(f"[device] {smi}")

    launches: Dict[str, int] = {}

    @contextlib.contextmanager
    def counted(section: str):
        """The section's cluster_labels launches into launches[section]."""
        cluster_labels.cluster_labels.launches = 0
        yield
        launches[section] = cluster_labels.cluster_labels.launches

    reps, nf = args.reps, args.frames
    cfg = getattr(config, args.profile)()
    N = cfg.shapes.max_points
    win = synthetic.render_window(synthetic.make_scene(), nf, N)
    xyz, inten, valid, poses = interop.window_from_numpy(win, device)

    # ---- headline: the full removal pipeline, ms/frame
    with counted("headline"):
        ms_per_frame = time_ms(lambda: pipeline.run_window(
            xyz, inten, valid, poses, cfg), reps, device) / nf

    # ---- stages, each timed as its own rep loop (ms/frame)
    with counted("stages"):
        x0, i0, v0 = xyz[0], inten[0], valid[0]
        pw = patchwork.estimate_ground(x0, v0, cfg.patchwork)
        seg, point_voxel, vgrid = segmentation.segment_frame(
            x0, i0, pw.nonground, pw.ground, pw.dropped, cfg)
        frames = pipeline.process_window(xyz, inten, valid, poses, cfg)
        pv_w = frames.state.point_voxel
        stages = {   # name: (fn, frames per call)
            "patchwork": (lambda: patchwork.estimate_ground(
                x0, v0, cfg.patchwork), 1),
            "segment": (lambda: segmentation.segment_frame(
                x0, i0, pw.nonground, pw.ground, pw.dropped, cfg), 1),
            "recognize": (lambda: recognition.recognize_points(
                seg.clusters, x0, seg.point_cluster, point_voxel, cfg), 1),
            "tracking": (lambda: tracking.track_window(
                xyz, pv_w, (pv_w >= 0) & valid, frames.state.label_grid,
                frames.state.clusters, poses, cfg), nf),
        }
        wall = {name: time_ms(fn, reps, device) / per
                for name, (fn, per) in stages.items()}
    err("[stages ms/frame] "
        + "  ".join(f"{n}={t:.2f}" for n, t in wall.items())
        + f"  (sum={sum(wall.values()):.2f}, e2e={ms_per_frame:.2f})")

    # ---- roofline: no cost model; kernel 1 against its bound instead
    for name in stages:
        err(f"[roofline] {name:<10} not measured (no cost model)")
    occ3 = (vgrid.count > 0).reshape(cfg.grid.shape)
    G, M = cfg.grid.bin_num, int(occ3.sum())
    bound = kernel_times.bound_ms("cluster_labels", G, M)
    gate = (cfg.seg.search_c, cfg.seg.intensity_cov, cfg.seg.intensity_diff,
            cfg.seg.far_range_frac)
    with counted("roofline"):
        k_ms = None
        if device.type == "cuda":
            k_ms = kernel_times.graph_ms(lambda: cluster_labels.cluster_labels(
                occ3, vgrid.intensity_mean, vgrid.intensity_var, *gate), reps)
    share = ("not measured (cpu)" if k_ms is None
             else f"device {k_ms:.4f} ms per call (CUDA graph of {reps} "
                  f"calls), {100 * bound / k_ms:.2f} % of the bound")
    err(f"[roofline] device={kind}  pipeline total not measured (no cost "
        f"model); kernel 1 cluster_labels on the segment stage's grid (G = "
        f"{G}, M = {M}): bound {bound * 1e3:.3f} us "
        f"({kernel_times.bound_bytes('cluster_labels', G, M)} B over 3.35 "
        f"TB/s), {share}  [{smi}]")
    err("[roofline] hand-check patchwork matmul flops: left out (the port "
        "sums patch moments and histograms with segment sums and bincount, "
        "not one-hot matmuls: there are no matmul flops to count)")

    # ---- trace: device time of each stage's rep loop against its wall time
    with counted("trace"):
        for name, (fn, per) in stages.items():
            dev = busy_ms(fn, reps, device)
            if dev is None:
                err(f"[trace] {name:<10} device {_fmt(None)}  wall "
                    f"{wall[name]:7.2f}")
            else:
                dev /= per
                err(f"[trace] {name:<10} device {dev:7.2f} ms/frame  wall "
                    f"{wall[name]:7.2f}  (host/dispatch "
                    f"{wall[name] - dev:+6.2f})")

    # ---- odometry: scan-to-scan GICP over F - 1 pairs, one pyramid pair
    with counted("odometry"):
        t_odo = time_ms(lambda: odometry.estimate_window_poses(
            xyz, valid, cfg), reps, device) / (nf - 1)
        err(f"[odometry] {t_odo:.2f} ms/frame (scan-to-scan GICP)")
        vm0 = gicp.build_voxel_map(xyz[0], valid[0], cfg.gicp)
        t_pair = time_ms(lambda: gicp.register_pyramid(
            xyz[1], valid[1], vm0, cfg.gicp).T, reps, device)
        err(f"[roofline] gicp pair {t_pair:6.2f} ms  not measured (no cost "
            f"model)")

    # ---- the streaming SLAM engine on the loop scene
    ec = slam_config()
    with counted("slam"):
        win_l = synthetic.render_window(synthetic.make_scene(slam_spec()),
                                        args.slam_frames, N)
        xyz_d, int_d, val_d = (torch.as_tensor(win_l[k], device=device)
                               for k in ("xyz", "intensity", "valid"))
        eng = engine.SlamEngine(cfg, ec, materialize_outputs=False,
                                device=device)
        t_steps = []          # (seconds, judged frames) of warm sync windows
        seen_variants = set()
        snap = None           # (state, first frame) before a steady window
        pipe_t0 = None
        pipe_frames = pipe_windows = pipe_erasor = 0
        prev_out = None
        for f in range(args.slam_frames):
            run_er = (ec.erasor_every > 0
                      and (eng.windows + 1) % ec.erasor_every == 0)
            variant = (eng.windows == 0, run_er)
            will_run = (len(eng._pending) + 1
                        >= (ec.window if eng.windows == 0
                            else ec.window - 1))
            if will_run and snap is None and variant in seen_variants \
                    and not run_er:
                snap = (eng.state, eng.n_frames - 1)
                snap_copy = [t.clone() for t in engine.state_leaves(
                    eng.state)]
            t0 = time.perf_counter()
            out = eng.feed(xyz_d[f], int_d[f], val_d[f])
            if out is None:
                continue
            if eng.windows < PIPE_FROM:
                float(out.pgo_error)        # host read = device sync
                warm = variant in seen_variants
                seen_variants.add(variant)
                if warm:
                    t_steps.append((time.perf_counter() - t0,
                                    out.removed.shape[0]))
                if eng.windows == PIPE_FROM - 1:
                    pipe_t0 = time.perf_counter()
            else:
                if prev_out is not None:
                    float(prev_out.pgo_error)   # sync window k - 1
                prev_out = out
                pipe_windows += 1
                pipe_frames += out.removed.shape[0]
                pipe_erasor += int(run_er)
        if prev_out is not None:
            float(prev_out.pgo_error)           # drain the pipeline
        pipe_wall = (time.perf_counter() - pipe_t0
                     if pipe_t0 is not None else 0.0)
        eng.finalize(final_erasor=True)
    ms_slam = (sum(t for t, _ in t_steps)
               / max(sum(k for _, k in t_steps), 1) * 1e3)
    ms_pipe = pipe_wall / max(pipe_frames, 1) * 1e3
    ate = float(odometry.ate_rmse(
        torch.as_tensor(eng.poses()),
        torch.as_tensor(win_l["poses"][eng.kf_frames()])))
    err(f"[slam] {ms_pipe:.2f} ms/frame streaming throughput "
        f"(depth-1 pipelined, {pipe_windows} steady windows incl. "
        f"{pipe_erasor} ERASOR passes), window latency "
        f"{ms_slam:.2f} ms/frame ({len(t_steps)} sync windows), "
        f"ATE {ate:.3f} m, {int(eng.state.n_loops)} loop edge(s), "
        f"{int(eng.state.odo_fallbacks)} odo fallbacks")

    # ---- engine-trace: one steady, non-ERASOR step from the snapshot,
    # and its parts each on its own; the remainder is tracking + submaps
    if snap is None:
        raise RuntimeError("[engine-trace] no steady window to snapshot: "
                           "--slam-frames is too small")
    st, f0 = snap
    W = ec.window
    with counted("engine-trace"):
        dev = engine_step_parts(st, snap_copy, xyz_d[f0:f0 + W],
                                int_d[f0:f0 + W], val_d[f0:f0 + W], ec, cfg,
                                device)
    rest = (None if dev["step"] is None
            else max(dev["step"] - dev["odometry"] - dev["loops"], 0.0))
    step = dev["step"]
    err("[engine-trace] step device " + (
        _fmt(None) if step is None else
        f"{step:7.2f} ms ({step / (W - 1):.2f} ms/frame over {W - 1} "
        f"judged)"))
    err(f"[engine-trace] odometry {_fmt(dev['odometry'])}  "
        f"tracking+submaps(remainder) {_fmt(rest)}  "
        f"loops(retrieval+verify) {_fmt(dev['loops'])}")
    err(f"[engine-trace] pgo {_fmt(dev['pgo'])} (loop windows only)  "
        f"erasor {_fmt(dev['erasor'])} (every {ec.erasor_every} windows)")
    err(f"[kernels] cluster_labels launches per section "
        f"{json.dumps(launches)}")

    print(json.dumps({
        "metric": "dynamic_removal_ms_per_frame",
        "value": round(ms_per_frame, 3),
        "unit": "ms/frame",
        "vs_baseline": round(BASELINE_MS / ms_per_frame, 3),
        "device": kind,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
