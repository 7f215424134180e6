#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (dr_using_scv_od_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):
  1. require CUDA, switch TF32 off, print the card's name and power limit;
  2. build the three kernels (csrc/cluster_labels.cu, cc_labels.cu,
     ri3_labels.cu) with nvcc for sm_90a, one process each, in parallel;
  3. run the main path, run_window at the full semantickitti() width
     (N = 131,072 points, G = 1,296,000 voxels, C = 512 clusters) on a
     5-frame synthetic window, counting the kernel's launches, and hold
     PR > 99 / RR > 96 / F1 > 0.97; print how many entries of removed,
     point_cluster, point_route and label_grids differ from the port's CPU
     run of the same window, and hold them identical;
  4. hold cluster_labels against cluster_labels_reference (identical int32
     labels, in each of 10 launches) on every frame's grid and on
     adversarial grids;
  5. time run_window (ms/frame, 6-frame window) and the kernel beside its
     plain version on a full-size grid, with CUDA events, and the kernel's
     device time (CUDA events around a CUDA graph of 20 calls) against its
     bound;
  6. hold cc_labels and ri3_labels against their plain versions (identical
     labels in each of 10 launches) on every frame grid, the cases of
     tests/test_cc_pallas.py and tests/test_ri3_pallas.py, and RI3 on a
     labelling that is no connected-components fixpoint; and check the
     identities ri3(cc(occ)) == cluster_labels(occ) and cc(occ) ==
     cluster_labels(occ, enable_shell=False) on every frame grid;
  7. run the stage profiler's cc, ri3, fused and gicp components (the
     entry point of the three kernels) at full width, counting each
     kernel's launches;
  8. odometry at full width on the 4-frame window of tests/test_odometry.py:
     scan-to-scan ATE < 0.15 m with > 5000 correspondences per pair,
     scan-to-map ATE < 0.05 m, run_window on the estimated poses PR > 98 /
     RR > 70, the card's poses against the port's CPU poses, and the
     time per registered pair;
  9. time cc_labels and ri3_labels beside their plain versions on the
     frame-0 grid, and their device times (CUDA graph) against their
     bounds;
 10. the streaming SLAM engine at full width with bench.py's [slam]
     EngineConfig: 36 frames of the loop scene (7 windows of 6) fed one
     scan at a time through SlamEngine.feed, then finalize(final_erasor=
     True). It checks that cluster_labels ran on every frame, that no
     overflow or fallback counter moved, that a loop edge spans the
     revisit, that the pose graph beats the chained odometry's ATE, that
     ERASOR removed map points, and tests/test_engine.py's RR > 88 /
     PR > 98 on the judged frames; resumes a checkpoint taken after
     window 3 on the card and holds it to the uninterrupted run
     (tests/test_engine.py:195-202); steps the first two windows on the
     CPU from the card's state (window 2 through a card checkpoint), holds
     the card's windows to them and prints how many entries of each
     integer output differ; and times the steady windows (ms/frame) and
     the parts of one steady window with CUDA events;
 11. hold cluster_labels and ri3_labels against their plain versions
     (identical labels in each of 10 launches) on full-size seam grids of
     the tile plan (ops/tile_plan.seam_grids: snakes through every tile
     along each axis, gated cheb-2 pairs across every tile face, a
     60 %-dense random grid, a voxel at every tile corner), on the
     60 x 72 x 300 grid and on 61 x 75 x 301, whose sides are no multiple
     of the tile; and cc_labels against connected_components on the seam
     grids of its radius-1 plan, on both shapes;
 12. drive the command-line entry points (dr_using_scv_od_tpu_torch.cli,
     in process, default device: the card) at full semantickitti() width:
     `segdf --frames 5 --iou --out` (judged-frame PR / RR / F1 equal to
     phase 3's to the digits printed, the per-frame static / dynamic PCDs
     read back and counted against phase 3's mask, cluster_labels launched
     once per frame); `odometry --frames 4` (ATE under 0.15 m);
     `bench-table` over configs/*.yaml (3 frames, one threshold);
     `slam --data` over a KITTI-layout directory written from 12 frames of
     the loop scene (prefetcher, decoder, --ckpt-every 6), then `--resume`
     from the first checkpoint (trajectory within 1e-5 of the
     uninterrupted run, cluster_labels launched on every frame); the
     host's time per scan on that path (decode, down-sample, pad, upload);
     `times` on the time.txt that segdf wrote; `features --frames 5`
     (its lines identical to those of the port's CPU run of the same window
     in phase 3, cluster_labels launched once per frame); and, on segdf's
     files, `evaluate` (voxel 0.2), `evaluate-map` (radii 0.15 / 0.1) and
     `erasor` (the map of frames 0-3, frame 4, its position), each once on
     the card and once with --device cpu: the lines, the TP/FN/TN/FP
     counts, the coloured cloud and the static / dynamic split identical,
     but for GT points whose exact nearest distance lies within 1e-5 m of
     a radius (counted and printed). No phase draws a figure: the machine
     may have no matplotlib;
 13. the parallel layer (dr_using_scv_od_tpu_torch/parallel) on a world of
     one rank under NCCL (a file store in a temporary directory, destroyed
     at the end): sharded_run_window at full width on the 6-frame window
     (cluster_labels launched 6 times; n_dynamic and removed identical to
     run_window's on frames 0..4; ms/frame of both with CUDA events),
     tp_voxel_stats on frame 0 (counts identical to the single-device
     sums), pipelined_process_window on 3 frames (integer outputs identical
     to process_window's), optimize_distributed and optimize_schur on
     tests/mp_worker.py's 32-node loop (error below 0.25 of the start,
     poses within the CPU tests' tolerances of posegraph.optimize, ms per
     solve), measure_scaling's one-rank row and dryrun_multichip(1). A
     multi-rank world needs one card per rank (NCCL refuses two ranks on
     one card); tests/test_torch_parallel*.py hold it on the CPU with gloo;
 14. the stage profiler (tools/profile_stages.py) over every component,
     printing the sub-stage table; on frame 0's grid, compact_labels +
     labels_to_grid against compact_grid_labels (identical), voxel_stats
     against voxel_stats_moments (counts identical, mean / var within
     1e-5), voxel_planarity against the moment planarity on the voxels
     the histograms use, both branches of recognize's point-level fallback
     against the grid path (identical types), refine_by_intensity at 24
     rounds against kernel 1 (identical); voxel_downsample of a
     131,072-point scan at 0.08 m (keep-mask identical on the card and the
     CPU; its card ms beside the host down-sample's ms); entry() (one
     kernel-1 launch, integer outputs identical to the CPU run of the same
     arguments); tools/drive_e2e.py (PR > 99 / RR > 96); the cascade
     experiment's ours_window on 6 frames (card and CPU identical);
 15. tests/test_engine_scale.py's long gated trajectory
     (tools/engine_scale.py): 96 scans, two laps of a 48-frame loop, fed
     one at a time through SlamEngine.feed at full semantickitti() width
     and at that file's tiny_cfg (N = 8,192), then finalize; each run
     holds that file's floors (no keyframe dropped, frames >= 4 x
     keyframes, keyframes spanning the run, >= 2 loop edges from >= 2
     queries, the pose graph's ATE < 0.8 x the chained odometry's, submaps
     topped up, < 1 % moving-car points in a map of > 10,000; the
     absolute ATE < 7.0 m at tiny_cfg only, where it was set), counts
     kernel 1's launches (one per frame of every window) and times the
     steady windows (ms/frame, CUDA events) beside phase 10's; then the
     budget case (the keyframe-budget error, 8 keyframes kept) and the
     false-positive case (the poisoned candidate rejected by GICP).
 16. the three stress scenes of tests/test_hard_scenes.py (wall-parked
     cars F = 4, a car that stops F = 6, both with tree clutter F = 6)
     through run_window at full width on the card and on the CPU: print
     PR / RR and how many entries of removed, point_cluster, point_route
     and label_grids differ, and hold them identical; then the port's
     benchmark, `python -m dr_using_scv_od_tpu_torch.tools.bench`, in a
     subprocess at its defaults (bench.py's sizes) with a bounded wait:
     exit 0, one stdout line with its five keys, `device` this card,
     vs_baseline = BASELINE_MS / value to the rounding, every section's
     stderr lines (printed here), and its per-section cluster_labels
     launches equal to what its calls imply (`bench_launches`).
The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from dr_using_scv_od_tpu_torch import cli, config, entry, interop
from dr_using_scv_od_tpu_torch.eval import metrics
from dr_using_scv_od_tpu_torch.models import (engine, odometry, patchwork,
                                              pipeline, posegraph,
                                              recognition, scan_context,
                                              segmentation)
from dr_using_scv_od_tpu_torch.ops import cc_labels as cc
from dr_using_scv_od_tpu_torch.ops import cluster_labels as cl
from dr_using_scv_od_tpu_torch.ops import (clustering, cuda_build, geometry,
                                          quantize, segment_ops, tile_plan)
from dr_using_scv_od_tpu_torch.ops import ri3_labels as ri3
from dr_using_scv_od_tpu_torch.parallel import (distributed_pgo, dryrun,
                                               pipeline_parallel, scaling,
                                               schur_pgo, sharded_pipeline,
                                               tensor_parallel)
from dr_using_scv_od_tpu_torch.parallel import mesh as pmesh
from dr_using_scv_od_tpu_torch.tools import (bench, cascade_experiment,
                                             drive_e2e, engine_scale,
                                             kernel_times, profile_stages)
from dr_using_scv_od_tpu_torch.utils import io_kitti, prefetch, synthetic

F_CHECK = 5        # window judged against the accuracy floors
F_TIME = 6         # window timed (bench.py's shape)
TIME_REPS = 3
KERNEL_REPS = 20
CHECK_REPS = 10    # the atomics' order varies from launch to launch
F_ODOM = 4         # tests/test_odometry.py's window
POSE_ATOL = 5e-4   # card vs CPU poses (tests/test_torch_odometry.py)
KERNELS = (cl.cluster_labels, cc.cc_labels, ri3.ri3_labels)
SLAM_FRAMES = 36   # 7 windows of 6: the loop scene's revisit is frame 24
SLAM_CKPT_WINDOW = 3
SLAM_CPU_WINDOWS = 2
# card vs CPU, one window stepped from the same state: rotation entries
# within POSE_ATOL; translations within 1e-3 m. Five chained registrations
# that stop at a step norm of 1e-4 leave the translations to the last bits
# of their sums: the card and the CPU differ by 3.4e-4 m in window 1, and
# summing GICP's accumulators in float64 instead moved that to 5.4e-4 m
# (rotation 6e-6 in both).
SLAM_T_ATOL = 1e-3
SLAM_INT_OUTPUTS = ("removed", "n_dynamic", "odo_n_corr", "is_kf", "kf_slot",
                    "loop_accepted", "loop_pair", "loop_ncorr")
LOOP_FRAMES = bench.slam_spec().loop_frames
SEAM_SHAPES = ((60, 72, 300), (61, 75, 301))
CLI_SLAM_FRAMES = 12
CLI_CKPT_EVERY = 6
# phase 13's pose-graph solves: converged settings on the 32-node loop, and
# each solve's distance to posegraph.optimize there, as
# tests/test_torch_parallel_pgo.py holds them (CG 1e-4, Schur 2e-4)
PGO_GN, PGO_CG = 15, 100
PGO_ATOL = (1e-4, 2e-4)
# phase 14: voxel_stats against voxel_stats_moments (the tolerance of
# tests/test_torch_stage_parts.py), the down-sampled scan, the cascade
STATS_ATOL = 1e-5
DOWNSAMPLE_POINTS = 131072
DOWNSAMPLE_LEAF = 0.08
CASCADE_FRAMES = 6
# phase 12's evaluation subcommands: the frame evaluated (a judged frame
# with moving-car points), evaluate's voxel, evaluate-map's two radii, and
# the band around a radius inside which a GT point's nearest distance
# (float64, exact) may be judged otherwise on the card and the CPU: the
# card's and the CPU's |a|^2 + |b|^2 - 2 a.b expansions round apart there
EVAL_FRAME = 1
EVAL_STRIDE = 8    # every 8th valid point of the frame is a GT point
EVAL_VOXEL = 0.2
EVAL_RADII = (0.15, 0.1)
NEAR_RADIUS = 1e-5
# phase 16: the scenes of tests/test_hard_scenes.py (SceneSpec fields, F),
# the bench's time limit and the prefixes of its stderr sections
HARD_SCENES = {
    "wall": (dict(wall_parked_cars=2), 4),
    "stop": (dict(stop_frame=2), 6),
    "clutter": (dict(wall_parked_cars=2, stop_frame=2, n_trees=12), 6),
}
BENCH_TIMEOUT = 600
BENCH_PREFIXES = ("[device]", "[stages ms/frame]", "[roofline]", "[trace]",
                  "[odometry]", "[slam]", "[engine-trace]", "[kernels]")


def _log(msg: str) -> None:
    print(msg, flush=True)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def adversarial_grids(device):
    """(name, occ3, mean, var, search_c, cov, diff, far_frac, shell)
    cases: random fuzz with the shell on and off, the multi-tile seam fuzz
    and the azimuth-wrap case of tests/test_fused_seg.py, and a sector
    seam that must not wrap."""
    shape3 = (6, 16, 64)

    def case(name, occ, av, var, diff, far, shell=True):
        return (name, torch.as_tensor(occ, device=device),
                torch.as_tensor(av.reshape(-1), device=device),
                torch.as_tensor(var.reshape(-1), device=device),
                2, 1.0, diff, far, shell)

    out = []
    for seed in range(4):
        rng = np.random.default_rng(seed + 5)
        occ = rng.random(shape3) < 0.08
        av = rng.uniform(0, 12, shape3).astype(np.float32)
        var = rng.uniform(0, 2.5, shape3).astype(np.float32)
        out.append(case(f"fuzz{seed}", occ, av, var, 2.0, 0.6))
        out.append(case(f"fuzz{seed}-noshell", occ, av, var, 2.0, 0.6,
                        shell=False))
    for seed in range(4):
        rng = np.random.default_rng(seed + 77)
        occ = rng.random(shape3) < 0.25
        av = rng.uniform(0, 4, shape3).astype(np.float32)
        out.append(case(f"seam{seed}", occ, av,
                        np.zeros(shape3, np.float32), 8.0, 1.0))
    occ = np.zeros(shape3, bool)
    occ[1, 5, 10] = occ[5, 5, 10] = occ[3, 5, 13] = True
    occ[4, 5, 10:14] = True
    flat = np.full(shape3, 2.0, np.float32)
    out.append(case("azimuth-wrap", occ, flat,
                    np.zeros(shape3, np.float32), 8.0, 1.0))
    occ = np.zeros(shape3, bool)
    occ[2, 5, 0] = occ[2, 5, shape3[2] - 1] = True   # cheb 1 across the seam
    occ[3, 7, 1] = occ[3, 7, shape3[2] - 2] = True   # cheb 2 across the seam
    out.append(case("sector-seam", occ, flat,
                    np.zeros(shape3, np.float32), 8.0, 1.0))
    return out


def cc_cases():
    """(name, occ3 numpy) cases of tests/test_cc_pallas.py: its shapes and
    densities, the multi-tile seam fuzz, no azimuth wraparound, the
    snake."""
    out = []
    for shape, density in (((4, 8, 16), 0.3), ((12, 16, 24), 0.2),
                           ((12, 16, 24), 0.6)):
        out.append((f"cc-{shape}-{density}",
                    np.random.default_rng(0).random(shape) < density))
    for seed in range(3):
        out.append((f"cc-seam{seed}", np.random.default_rng(seed + 19)
                    .random((12, 16, 24)) < 0.35))
    occ = np.zeros((12, 16, 24), bool)
    occ[0, 5, 10] = True
    occ[5:10, 5, 10] = True
    out.append(("cc-no-azimuth-wrap", occ))
    occ = np.zeros((6, 8, 40), bool)
    occ[2, 3, :] = True
    occ[3, 4, 39] = True
    occ[0, 0, 0] = True
    out.append(("cc-snake", occ))
    return out


def ri3_cases():
    """(name, occ3, mean, var, far_range_frac, must_merge, a, b) semantic
    cases of tests/test_ri3_pallas.py (search_c 2, cov 1, diff 2): voxels
    a and b must (or must not) share a label."""
    shape3 = (4, 8, 32)
    out = []

    def grid(shape=shape3):
        return (np.zeros(shape, bool), np.zeros(shape, np.float32),
                np.zeros(shape, np.float32))

    occ, av, var = grid()
    occ[1, 3, 5] = occ[1, 3, 7] = occ[1, 3, 20] = True
    av[1, 3, 5], av[1, 3, 7], av[1, 3, 20] = 100.0, 101.0, 100.0
    out.append(("ri3-qualifying-gap", occ, av, var, 1.0, True,
                (1, 3, 5), (1, 3, 7)))
    out.append(("ri3-far-cluster", occ, av, var, 1.0, False,
                (1, 3, 5), (1, 3, 20)))
    occ, av, var = grid()
    occ[1, 3, 5] = occ[1, 3, 7] = True
    av[:] = 100.0
    var[1, 3, 5] = var[1, 3, 7] = 50.0
    out.append(("ri3-bad-variance", occ, av, var, 1.0, False,
                (1, 3, 5), (1, 3, 7)))
    occ, av, var = grid()
    occ[1, 3, 5] = occ[1, 3, 7] = True
    av[1, 3, 5], av[1, 3, 7] = 100.0, 150.0
    out.append(("ri3-intensity-differs", occ, av, var, 1.0, False,
                (1, 3, 5), (1, 3, 7)))
    occ, av, var = grid()
    occ[1, 3, 2:6] = occ[1, 3, 7:11] = True
    av[1, 3, 2:6], av[1, 3, 7:11] = 100.0, 101.0
    var[1, 3, 3] = var[1, 3, 9] = 99.0
    out.append(("ri3-spread-across-cluster", occ, av, var, 1.0, True,
                (1, 3, 2), (1, 3, 10)))
    occ, av, var = grid((4, 16, 32))
    occ[1, 14, 5] = occ[1, 14, 7] = True
    av[:] = 100.0
    out.append(("ri3-far-range-shrink", occ, av, var, 0.6, False,
                (1, 14, 5), (1, 14, 7)))
    return out


def _device_ms(name, fn, G, M) -> float:
    """Device ms per call of kernel `name`: CUDA events around the replay
    of a CUDA graph that holds KERNEL_REPS wrapper calls (the device's work
    and the launch gaps inside the graph, no host), logged with its bound.
    tools/kernel_times.py splits it by CUDA kernel with torch.profiler."""
    ms = kernel_times.graph_ms(fn, KERNEL_REPS)
    bound = kernel_times.bound_ms(name, G, M)
    _log(f"{name} device time {ms:.4f} ms per call (bound {bound:.6f} ms, "
         f"{100 * bound / ms:.2f} % of it; G = {G}, M = {M})")
    return ms


def _time_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_vs_cpu(res, ref) -> dict:
    """How many entries of removed, point_cluster, point_route and
    label_grids differ between two WindowResults (the card's, the CPU's)."""
    return {name: int((getattr(a, name).cpu() != getattr(b, name)).sum())
            for name, a, b in (
                ("removed", res, ref), ("point_cluster", res, ref),
                ("point_route", res.frames.state, ref.frames.state),
                ("label_grids", res, ref))}


def slam_window(n_frames: int, n_points: int):
    """bench.py's [slam] scene (tools/bench.slam_spec): a 24-frame circle
    of radius 18 m, two moving cars."""
    return synthetic.render_window(synthetic.make_scene(bench.slam_spec()),
                                   n_frames, n_points)


def drive_slam(eng, scans, frames, on_window=None, timed=False):
    """Feed `frames` of `scans` (xyz, intensity, valid stacked on the frame
    axis) one at a time. Returns ({frame: removed [N] bool} of the judged
    frames, [(window, ms, new frames)] when `timed`: CUDA events around
    each feed that ran a window)."""
    xyz, inten, valid = scans
    removed, times = {}, []
    for f in frames:
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        out = eng.feed(xyz[f], inten[f], valid[f])
        if out is None:
            continue
        if timed:
            end.record()
            torch.cuda.synchronize()
            new = out.poses.shape[0] - (0 if eng.windows == 1 else 1)
            times.append((eng.windows, start.elapsed_time(end), new))
        base = eng.n_frames - out.poses.shape[0]
        for k in range(out.removed.shape[0]):
            removed[base + k] = out.removed[k]
        if on_window is not None:
            on_window(eng)
    return removed, times


def slam_accuracy(win, removed, cfg):
    """tests/test_engine.py:104-131: RR over the in-grid moving-car points
    and PR over the static points of every judged frame."""
    dyn_total = dyn_removed = stat_total = stat_removed = 0
    for f, mask in removed.items():
        lab, val = win["label"][f], win["valid"][f]
        rng2d = np.linalg.norm(win["xyz"][f][:, :2], axis=1)
        in_grid = (rng2d > cfg.grid.min_dis) & (rng2d < cfg.grid.max_dis)
        dyn = val & in_grid & (lab == synthetic.LABEL_CAR_MOVING)
        stat = val & (lab != synthetic.LABEL_CAR_MOVING)
        dyn_total += int(dyn.sum())
        dyn_removed += int((dyn & mask).sum())
        stat_total += int(stat.sum())
        stat_removed += int((stat & mask).sum())
    _check(dyn_total > 0, "no in-grid moving-car points were judged")
    return (100.0 * dyn_removed / dyn_total,
            100.0 * (stat_total - stat_removed) / stat_total)


def slam_phase(dev, cfg):
    """Phase 10. Returns the cluster_labels launches of the engine run."""
    ec = bench.slam_config()
    N = cfg.shapes.max_points
    W = ec.window
    win = slam_window(SLAM_FRAMES, N)
    keys = ("xyz", "intensity", "valid")
    scans = tuple(torch.as_tensor(win[k], device=dev) for k in keys)
    ckpt_dir = Path(tempfile.mkdtemp(prefix="slam_ckpt_"))
    states, snap = {}, {}

    def on_window(eng):
        states[eng.windows] = eng.state       # states are never mutated
        if eng.windows == SLAM_CKPT_WINDOW or eng.windows < SLAM_CPU_WINDOWS:
            snap[eng.windows] = (eng.checkpoint(
                str(ckpt_dir / f"engine_{eng.windows}")), eng.n_frames)

    for k in KERNELS:
        k.launches = 0
    eng = engine.SlamEngine(cfg, ec, device=dev)
    removed, times = drive_slam(eng, scans, range(SLAM_FRAMES), on_window,
                                timed=True)
    eng.finalize(final_erasor=True)
    torch.cuda.synchronize()
    launches = cl.cluster_labels.launches
    in_windows = sum(o.poses.shape[0] for o in eng.outputs)
    _log(f"slam: {eng.windows} windows, {eng.n_frames} frames, "
         f"{launches} cluster_labels launches ({in_windows} frames in "
         f"windows)")
    _check(launches >= in_windows,
           "the engine did not go through cluster_labels on every frame")

    # ---- the run's own checks
    st = eng.state
    counters = {name: int(getattr(st, name)) for name in (
        "kf_overflow", "odo_fallbacks", "row_overflow", "point_overflow",
        "submap_overflow")}
    _log(f"slam counters: {counters}, erasor_removed "
         f"{int(st.erasor_removed)}")
    _check(not any(counters.values()), f"a counter moved: {counters}")
    _check(int(st.erasor_removed) > 0, "ERASOR removed no map point")
    n = eng.n_keyframes
    kff = eng.kf_frames()
    nl = int(st.n_loops)
    spans = [(int(kff[i]), int(kff[j])) for i, j in zip(
        st.loop_i[:nl].tolist(), st.loop_j[:nl].tolist())]
    _log(f"slam: {n} keyframes, {nl} loop edges (frame pairs {spans})")
    _check(any(abs(fj - fi - LOOP_FRAMES) <= 4 for fi, fj in spans),
           "no accepted loop edge spans the revisit")
    gt = torch.from_numpy(win["poses"][kff])
    ate_pgo = float(odometry.ate_rmse(torch.from_numpy(eng.poses()), gt))
    chain = posegraph.odometry_chain(st.rel_T[1:n].cpu())
    ate_chain = float(odometry.ate_rmse(chain, gt))
    _log(f"slam ATE: pose graph {ate_pgo:.5f} m, chained odometry "
         f"{ate_chain:.5f} m")
    _check(ate_pgo < ate_chain, "the pose graph did not beat the chained "
           "odometry's ATE")
    rr, pr = slam_accuracy(win, removed, cfg)
    _log(f"slam judged frames: RR {rr:.3f} (in-grid) PR {pr:.3f} over "
         f"{len(removed)} frames")
    _check(rr > 88.0 and pr > 98.0, "RR > 88 / PR > 98 missed")

    # ---- checkpoint after window 3, resumed on the card
    path, done = snap[SLAM_CKPT_WINDOW]
    eng_r = engine.SlamEngine.resume(path, cfg, ec, device=dev)
    drive_slam(eng_r, scans, range(done, SLAM_FRAMES))
    eng_r.finalize(final_erasor=True)
    dpose = float(np.abs(eng_r.poses() - eng.poses()).max())
    _log(f"slam resume after window {SLAM_CKPT_WINDOW}: poses differ by "
         f"{dpose:.3e}")
    _check(eng_r.n_frames == eng.n_frames, "resumed run frame count")
    _check(np.allclose(eng_r.poses(), eng.poses(), rtol=1e-5, atol=1e-5),
           "resumed poses differ from the uninterrupted run")
    _check(torch.equal(eng_r.state.submap_valid, st.submap_valid),
           "resumed submap_valid differs")
    _check(bool(((eng_r.state.desc - st.desc).abs() <= 1e-6).all()),
           "resumed descriptors differ")
    _check(int(eng_r.state.track_counter) == int(st.track_counter),
           "resumed track_counter differs")

    # ---- the first windows against the port's CPU run, each stepped from
    # the same state: window 1 from the start, window k from the card's
    # checkpoint after window k - 1 resumed on the CPU (so the comparison
    # holds the window step, not the drift that odometry carries forward)
    cpu_scans = tuple(torch.from_numpy(win[k]) for k in keys)
    for k in range(SLAM_CPU_WINDOWS):
        if k == 0:
            eng_c, lo = engine.SlamEngine(cfg, ec, device="cpu"), 0
        else:
            path, lo = snap[k]
            eng_c = engine.SlamEngine.resume(path, cfg, ec, device="cpu")
        hi = lo + (W if k == 0 else W - 1)
        drive_slam(eng_c, cpu_scans, range(lo, hi))
        g, c = eng.outputs[k], eng_c.outputs[0]
        drot = float(np.abs(g.poses[:, :3, :3] - c.poses[:, :3, :3]).max())
        dt = float(np.abs(g.poses[:, :3, 3] - c.poses[:, :3, 3]).max())
        ints = {name: int((getattr(g, name) != getattr(c, name)).sum())
                for name in SLAM_INT_OUTPUTS}
        _log(f"slam window {k + 1}, card vs cpu from the same state: "
             f"rotation {drot:.3e}, translation {dt:.3e} m; integer entries "
             f"that differ {json.dumps(ints)}")
        _check(drot < POSE_ATOL and dt < SLAM_T_ATOL,
               f"window {k + 1}: card and cpu poses differ by >= "
               f"{POSE_ATOL} (rotation) or {SLAM_T_ATOL} m")
        _check(not any(ints.values()),
               f"window {k + 1}: card and cpu integer outputs differ")
    for p in ckpt_dir.iterdir():
        p.unlink()
    ckpt_dir.rmdir()

    # ---- timing: steady windows, and the parts of one steady window
    steady = [(w, ms, new) for w, ms, new in times if w > 1]
    ms_frame = sum(ms for _, ms, _ in steady) / sum(n for _, _, n in steady)
    _log("slam windows (window, ms, new frames): "
         + ", ".join(f"({w}, {ms:.1f}, {n})" for w, ms, n in times))
    _log(f"slam: {ms_frame:.3f} ms/frame over the {len(steady)} steady "
         f"windows (ERASOR every {ec.erasor_every}, PGO where a loop "
         f"landed)")
    wb = max(w for w, _, _ in times if any(eng.outputs[w - 1].loop_accepted))
    st0 = states[wb - 1]
    out = eng.outputs[wb - 1]
    lo = W + (wb - 2) * (W - 1) - 1
    xs, ins, vs = (t[lo:lo + W] for t in scans)
    poses_win = torch.as_tensor(out.poses, device=dev)
    slots = torch.as_tensor(out.kf_slot, device=dev)
    is_kf = torch.as_tensor(out.is_kf, device=dev)
    removed_w = torch.as_tensor(out.removed, device=dev)
    frame_ids = torch.arange(lo, lo + W, dtype=torch.int32, device=dev)

    def loops():
        descs = torch.stack([scan_context.descriptor(xs[f], vs[f], ec.desc)
                             for f in range(W)])
        return engine._window_loops(st0, xs, vs, descs, slots, is_kf, False,
                                    ec, cfg)

    parts = {
        "odometry": lambda: engine._window_odometry(st0, xs, vs, False, ec,
                                                    cfg),
        "run_window": lambda: pipeline.run_window(
            xs, ins, vs, poses_win, cfg,
            init_track=(st0.track_table, st0.track_grid,
                        st0.track_counter)),
        "submaps": lambda: engine._insert_submaps(
            st0, xs[:-1], vs[:-1], removed_w, st0.poses, poses_win[:-1],
            slots[:-1], is_kf[:-1], frame_ids[:-1], ec),
        "loops": loops,
        "pgo": lambda: engine._run_pgo(st, st.n, ec),
        "erasor": lambda: engine._erasor_pass(st0, xs[-1], vs[-1],
                                              st0.last_pose, ec),
        "whole window": lambda: engine.process_window(
            st0, xs, ins, vs, False, False, ec, cfg),
    }
    split = {name: _time_ms(fn, TIME_REPS) for name, fn in parts.items()}
    _log(f"slam window {wb} (a loop landed) parts, ms: "
         + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    return launches, ms_frame


def scale_phase(dev, slam_ms):
    """Phase 15: tests/test_engine_scale.py's long gated trajectory on the
    card at full width and at that file's tiny_cfg, and its two short
    cases. `slam_ms` is phase 10's ms/frame. Returns {width: cluster_labels
    launches}."""
    ec = engine_scale.long_run_config()
    launches = {}
    for width, cfg in (("full", config.semantickitti()),
                       ("tiny", engine_scale.tiny_cfg())):
        t0 = time.perf_counter()
        win = engine_scale.long_run_window(cfg.shapes.max_points)
        scans = tuple(torch.as_tensor(win[k], device=dev)
                      for k in ("xyz", "intensity", "valid"))
        for k in KERNELS:
            k.launches = 0
        eng = engine.SlamEngine(cfg, ec, device=dev)
        _, times = drive_slam(eng, scans, range(engine_scale.F_LONG),
                              timed=True)
        eng.finalize(final_erasor=True)
        torch.cuda.synchronize()
        n = launches[width] = cl.cluster_labels.launches
        in_windows = sum(o.poses.shape[0] for o in eng.outputs)
        steady = [(ms, new) for w, ms, new in times if w > 1]
        ms_frame = sum(ms for ms, _ in steady) / sum(n for _, n in steady)
        fl = engine_scale.floors(eng, win)
        ate_floor = engine_scale.ATE_FLOOR if width == "tiny" else None
        missed = engine_scale.missed_floors(fl, ec, ate_floor)
        _log(f"long gated run, {width} width (N = {cfg.shapes.max_points}): "
             f"{json.dumps(fl)}; pose-graph ATE {fl['ate_pgo']:.5f} m "
             f"(the tiny_cfg floor is {engine_scale.ATE_FLOOR} m), chained "
             f"{fl['ate_chain']:.5f} m; {n} cluster_labels launches "
             f"({in_windows} frames in {eng.windows} windows); "
             f"{ms_frame:.3f} ms/frame over {len(steady)} steady windows "
             f"(phase 10: {slam_ms:.3f}); {time.perf_counter() - t0:.1f} s; "
             f"floors missed: {missed or 'none'}")
        _check(not missed, f"long gated run, {width} width: floors missed "
               f"{missed}")
        _check(n == in_windows and n >= engine_scale.F_LONG,
               f"long gated run, {width} width: {n} cluster_labels launches "
               f"for {in_windows} frames in windows")

    err, kf_frame = engine_scale.budget_case(dev)
    _check(err is not None and "keyframe budget" in err,
           f"the budget case raised {err!r}")
    _check(int((kf_frame >= 0).sum()) == kf_frame.shape[0],
           "the budget case lost a keyframe it had")
    fp = engine_scale.false_positive_case(
        dev, engine_scale.false_positive_noise())
    _check(fp["scores"][0] > 0.95, "the poisoned candidate was not retrieved")
    _check(not fp["accepted"][0] and bool((fp["pairs"][0] == -1).all())
           and not bool((fp["new_edges"][:, 0] == 1).any()),
           "GICP verification accepted the poisoned candidate")
    _log(f"budget case: raised ({err.split(':')[0]}), {kf_frame.shape[0]} "
         f"keyframes kept; false-positive case: top score "
         f"{fp['scores'][0]:.4f} rejected, accepted {fp['accepted'].tolist()}"
         f", loop edges {fp['n_loops_before']} -> {fp['n_loops']}")
    return launches


def _cli(argv) -> list:
    """Run one subcommand of the port's command line in process (default
    device), log what it printed, and return the lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    lines = buf.getvalue().splitlines()
    for line in lines:
        _log(f"  cli {argv[0]}| {line}")
    _check(rc == 0, f"cli {argv[0]} returned {rc}")
    return lines


def _exact_nn(query: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Nearest distance of each query point to `ref` in float64, by direct
    differences (no expansion)."""
    ref = ref.astype(np.float64)
    return np.array([np.sqrt(((ref - q) ** 2).sum(1).min())
                     for q in query.astype(np.float64)])


def _hold_radius_tests(name, gt, refs, d2, radii):
    """The per-point outcomes of a radius test on the card and the CPU:
    `d2[device][k]` are the squared nearest distances of the GT points to
    `refs[k]` on that device, tested against `radii[k]`. Every point that
    takes another side of a radius on the card must have its exact nearest
    distance within NEAR_RADIUS of that radius. Returns (points that
    differ, GT points whose CPU distance lies within NEAR_RADIUS of a
    radius, the largest card - CPU difference of a squared distance in m^2,
    GT points whose CPU squared distance lies within that of a radius'
    square)."""
    n_diff = n_near = n_open = 0
    gaps = []
    for dg, dc in zip(d2["card"], d2["cpu"]):
        fin = np.isfinite(dg) & np.isfinite(dc)
        gaps.append(float(np.abs(dg[fin] - dc[fin]).max()) if fin.any()
                    else 0.0)
    gap = max(gaps)
    for ref, dg, dc, r in zip(refs, d2["card"], d2["cpu"], radii):
        n_near += int((np.abs(np.sqrt(dc.astype(np.float64)) - r)
                       <= NEAR_RADIUS).sum())
        n_open += int((np.abs(dc - r * r) <= gap).sum())
        flip = (dg < r * r) != (dc < r * r)
        if flip.any():
            exact = _exact_nn(gt[flip], ref)
            _check(bool((np.abs(exact - r) <= NEAR_RADIUS).all()),
                   f"{name}: a point {float(np.abs(exact - r).max()):.3e} m "
                   f"from the {r} m radius takes another side on the card")
        n_diff += int(flip.sum())
    return n_diff, n_near, gap, n_open


def eval_phase(dev, root, segdf_out, win):
    """Phase 12's `evaluate`, `evaluate-map` and `erasor` on the files that
    segdf wrote: each through cli.main on the card (the default device) and
    with --device cpu; the printed lines must be identical but for points
    on a radius (see _hold_radius_tests)."""
    from dr_using_scv_od_tpu_torch.eval import artifact
    f = EVAL_FRAME
    v = win["valid"][f]
    gt = np.concatenate([win["xyz"][f][v], win["label"][f][v, None]
                         .astype(np.float32)], axis=1)[::EVAL_STRIDE]
    gt_path = root / "gt.pcd"
    io_kitti.write_pcd_xyzi(gt_path, gt)
    static = segdf_out / f"{f:06d}_static.pcd"
    dynamic = segdf_out / f"{f:06d}_dynamic.pcd"
    st_xyz = io_kitti.read_pcd_xyzi(static)[:, :3]
    dy_xyz = io_kitti.read_pcd_xyzi(dynamic)[:, :3]

    def both(argv, outs=()):
        """(card lines, cpu lines): argv's `{dev}` output paths get the
        device's name."""
        lines = {}
        for tag, extra in (("card", []), ("cpu", ["--device", "cpu"])):
            a = [str(x).replace("{dev}", tag) for x in argv]
            t0 = time.perf_counter()
            lines[tag] = _cli(a[:1] + extra + a[1:])
            torch.cuda.synchronize()
            _log(f"  cli {argv[0]} on the {tag}: "
                 f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        return lines["card"], lines["cpu"]

    def d2(ref):
        if not len(ref):            # as four_outcome_map: no point is near
            return {tag: np.full(len(gt), np.inf, np.float32)
                    for tag in ("card", "cpu")}
        return {tag: artifact.nn_distances(gt[:, :3], ref, device=d)
                .cpu().numpy() for tag, d in (("card", dev), ("cpu", "cpu"))}

    # ---- evaluate: the static map against the labelled frame
    card, cpu = both(["evaluate", "--gt", gt_path, "--est", static,
                      "--voxel", EVAL_VOXEL])
    thr = EVAL_VOXEL * np.sqrt(3.0) / 2.0
    ds, dd = d2(st_xyz), d2(dy_xyz)
    n_diff, n_near, gap, n_open = _hold_radius_tests(
        "evaluate", gt[:, :3], [st_xyz], {k: [ds[k]] for k in ds}, [thr])
    _log(f"cli evaluate, card vs cpu: {n_diff} of {len(gt)} GT points "
         f"judged otherwise, {n_near} within {NEAR_RADIUS} m of the "
         f"{thr:.6f} m radius; squared distances up to {gap:.3e} m^2 apart, "
         f"{n_open} points that close to the radius; lines "
         f"{'identical' if card == cpu else 'differ'}")
    _check(card == cpu or n_diff > 0, "cli evaluate: the lines differ on "
           "the card and the CPU with no point judged otherwise")
    _check(card[0].startswith("PR=") and len(card) >= 2,
           f"cli evaluate printed {card!r}")

    # ---- evaluate-map: the four outcomes at the two radii
    out_map = root / "evaluate_{dev}.pcd"
    card, cpu = both(["evaluate-map", "--gt", gt_path, "--static", static,
                      "--dynamic", dynamic, "--radius", EVAL_RADII[0],
                      "--radius2", EVAL_RADII[1], "--out", out_map])
    refs = [st_xyz, st_xyz, dy_xyz, dy_xyz]
    radii = [EVAL_RADII[0], EVAL_RADII[1], EVAL_RADII[0], EVAL_RADII[1]]
    n_diff, n_near, gap, n_open = _hold_radius_tests(
        "evaluate-map", gt[:, :3], refs,
        {k: [ds[k], ds[k], dd[k], dd[k]] for k in ("card", "cpu")}, radii)
    counts = [c.split(" -> ")[0] for c in (card[0], cpu[0])]
    _log(f"cli evaluate-map, card vs cpu: {n_diff} (point, radius) tests "
         f"differ, {n_near} within {NEAR_RADIUS} m of a radius; squared "
         f"distances up to {gap:.3e} m^2 apart, {n_open} tests that close "
         f"to a radius; counts {counts[0]!r} on the card, {counts[1]!r} on "
         f"the CPU")
    _check(counts[0] == counts[1] or n_diff > 0, "cli evaluate-map: the "
           "TP/FN/TN/FP counts differ with no radius test judged otherwise")
    pcds = [io_kitti.read_pcd_xyzi(str(out_map).replace("{dev}", t))
            for t in ("card", "cpu")] if n_diff == 0 else []
    _check(n_diff > 0 or np.array_equal(pcds[0], pcds[1]),
           "cli evaluate-map: the coloured clouds differ")

    # ---- erasor: the map of frames 0..3 (static and dynamic clouds) in the
    # world frame against the whole of frame 4, seen from frame 4's position
    def world(f, pts):
        T = win["poses"][f]
        return (pts[:, :3] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)

    m = np.concatenate([world(g, io_kitti.read_pcd_xyzi(
        segdf_out / f"{g:06d}_{part}.pcd")) for g in range(4)
        for part in ("static", "dynamic")])
    io_kitti.write_pcd_xyzi(root / "map.pcd", np.concatenate(
        [m, np.zeros((len(m), 1), np.float32)], axis=1))
    v4 = win["valid"][4]
    scan = world(4, win["xyz"][4][v4])
    io_kitti.write_pcd_xyzi(root / "scan.pcd", np.concatenate(
        [scan, np.zeros((len(scan), 1), np.float32)], axis=1))
    ego = json.dumps([float(x) for x in win["poses"][4][:3, 3]])
    card, cpu = both(["erasor", "--map", root / "map.pcd", "--scan",
                      root / "scan.pcd", "--ego", ego,
                      "--out-static", root / "erasor_s_{dev}.pcd",
                      "--out-dynamic", root / "erasor_d_{dev}.pcd"])
    _check(card == cpu, f"cli erasor printed {card!r} on the card, {cpu!r} "
           f"on the CPU")
    for part in ("s", "d"):
        a, b = (io_kitti.read_pcd_xyzi(root / f"erasor_{part}_{t}.pcd")
                for t in ("card", "cpu"))
        _check(np.array_equal(a, b), f"cli erasor: the {part} clouds differ")
    _check(" dynamic 0 " not in card[0], "cli erasor judged no map point "
           "dynamic")
    _log(f"cli erasor: card and cpu identical ({card[0]})")


def cli_phase(dev, cfg, res, cpu_res, metrics_judged, scene):
    """Phase 12. `res`, `cpu_res` and `metrics_judged` are phase 3's
    run_window results on the card and on the CPU and its judged-frame
    metrics, on the window `segdf --frames 5` loads. Returns {entry point:
    cluster_labels launches}."""
    N = cfg.shapes.max_points
    root = Path(tempfile.mkdtemp(prefix="cli_smoke_"))
    launches = {}

    def counted(name, argv):
        for k in KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        lines = _cli(argv)
        torch.cuda.synchronize()
        launches[name] = cl.cluster_labels.launches
        return lines, (time.perf_counter() - t0) * 1e3

    # ---- segdf: the numbers of phase 3, the artifacts, one launch a frame
    out = root / "segdf"
    lines, _ = counted("segdf", ["segdf", "--frames", F_CHECK, "--iou",
                                 "--out", out])
    m = metrics_judged
    want = f"(judged frames: PR={m.pr:.2f} RR={m.rr:.2f} F1={m.f1:.4f})"
    _check(lines[0].endswith(want),
           f"segdf printed {lines[0]!r}, phase 3 measured {want}")
    _check(sum(line.startswith("  IoU ") for line in lines) == 5,
           "segdf --iou did not print five IoU lines")
    _check(launches["segdf"] == F_CHECK, f"segdf launched cluster_labels "
           f"{launches['segdf']} times over {F_CHECK} frames")
    win = synthetic.render_window(scene, F_CHECK, N)
    removed = res.removed.cpu().numpy()
    for f in range(F_CHECK):
        n_static = len(io_kitti.read_pcd_xyzi(out / f"{f:06d}_static.pcd"))
        n_dynamic = len(io_kitti.read_pcd_xyzi(out / f"{f:06d}_dynamic.pcd"))
        _check(n_static == int((win["valid"][f] & ~removed[f]).sum())
               and n_dynamic == int((win["valid"][f] & removed[f]).sum()),
               f"segdf frame {f}: PCD point counts differ from the mask")
        _check((out / f"{f:06d}_seg.pcd").stat().st_size > 0, "no seg PCD")
    stage_ms = [float(v) for v in
                (out / "time.txt").read_text().split()]
    _log(f"cli segdf: pipeline stage {stage_ms[-1]:.3f} ms for {F_CHECK} "
         f"frames = {stage_ms[-1] / F_CHECK:.3f} ms/frame (time.txt, mask "
         f"fetched to the host), PCD point counts equal the mask on "
         f"{F_CHECK} frames")

    # ---- times: the summary of the time.txt that segdf wrote
    lines = _cli(["times", "--log", out / "time.txt"])
    _check(lines == [f"  stage0: {stage_ms[0]:.2f} ms",
                     f"  total: {stage_ms[0]:.2f} ms over 1 frames"],
           f"cli times printed {lines!r} for a log of {stage_ms!r}")

    # ---- features on the card: the lines of the port's CPU run of the
    # same window (phase 3's), one launch a frame
    lines, _ = counted("features", ["features", "--frames", F_CHECK])
    want = cli.feature_report(win["xyz"], cpu_res, cfg)[1]
    _check(lines == want and len(lines) >= 8,
           f"cli features printed {lines!r}; the CPU run gives {want!r}")
    _check(launches["features"] == F_CHECK, f"features launched "
           f"cluster_labels {launches['features']} times over {F_CHECK} "
           f"frames")

    # ---- evaluate, evaluate-map and erasor on segdf's files, card and CPU
    eval_phase(dev, root, out, win)

    # ---- odometry
    lines, _ = counted("odometry", ["odometry", "--frames", F_ODOM,
                                    "--out", root / "poses.txt"])
    ate = float(re.search(r"ATE_rmse=([0-9.]+)", lines[0]).group(1))
    _check(ate < 0.15, f"cli odometry ATE {ate} >= 0.15 m")
    _check(np.loadtxt(root / "poses.txt").shape == (F_ODOM, 12),
           "cli odometry wrote no poses")

    # ---- bench-table over the repo's YAML profiles
    profiles = sorted((Path(__file__).resolve().parent / "configs")
                      .glob("*.yaml"))
    lines, ms = counted("bench-table", [
        "bench-table", "--frames", 3, "--thresholds", "0.5",
        "--profiles", profiles[0].parent])
    rows = [line for line in lines[2:] if line.startswith("|")]
    _check(len(profiles) > 0 and len(rows) == 4 * len(profiles),
           f"bench-table printed {len(rows)} rows for {len(profiles)} "
           f"profiles")
    _check(all(float(r.split("|")[4]) > 90.0 for r in rows),
           "a bench-table row has PR <= 90")
    _log(f"cli bench-table: {len(rows)} rows in {ms:.1f} ms")

    # ---- slam --data over a KITTI-layout directory, checkpoints, resume.
    # cfg.skip = 5: the files 0, 5, 10, ... of the listing are streamed, so
    # those hold the frames and the others are empty placeholders.
    data = root / "velodyne"
    data.mkdir()
    swin = slam_window(CLI_SLAM_FRAMES, N)
    n_files = (CLI_SLAM_FRAMES - 1) * cfg.skip + 1
    for i in range(n_files):
        pts = np.zeros((0, 4), np.float32)
        if i % cfg.skip == 0:
            f = i // cfg.skip
            v = swin["valid"][f]
            pts = np.concatenate(
                [swin["xyz"][f][v],
                 (swin["intensity"][f][v] / cfg.max_intensity)[:, None]],
                axis=1).astype(np.float32)
        pts.tofile(data / f"{i:06d}.bin")
    slam = ["slam", "--data", data, "--end", 0, "--kf-dist", 4.0,
            "--loop-min-score", 0.84, "--erasor-max-range", 45.0,
            "--erasor-max-pts", 256]
    out_a, out_b = root / "slam_a", root / "slam_b"
    lines, ms = counted("slam", slam + ["--ckpt-every", CLI_CKPT_EVERY,
                                        "--out", out_a])
    head = next(line for line in lines if line.startswith("frames="))
    _check(head.startswith(f"frames={CLI_SLAM_FRAMES} "),
           f"cli slam processed {head!r}, expected {CLI_SLAM_FRAMES} frames")
    _check("odo_fallbacks=0" in head, "cli slam: an odometry fallback")
    _check(launches["slam"] >= CLI_SLAM_FRAMES, "cli slam did not go "
           "through cluster_labels on every frame")
    _log(f"cli slam --data: {ms:.1f} ms for {CLI_SLAM_FRAMES} frames = "
         f"{ms / CLI_SLAM_FRAMES:.3f} ms/frame (host clock, decode and "
         f"finalize included), {launches['slam']} cluster_labels launches")
    ckpts = sorted(out_a.glob("engine_*.npz"))
    _check(len(ckpts) >= 1 and (out_a / "map_static.pcd").stat().st_size > 0,
           "cli slam wrote no checkpoint or no map")
    first = str(ckpts[0])[:-len(".npz")]
    lines, _ = counted("slam --resume", slam + ["--resume", first,
                                                "--out", out_b])
    _check(lines[0] == f"resumed at frame {CLI_CKPT_EVERY} from {first}",
           f"cli slam --resume printed {lines[0]!r}")
    _check(launches["slam --resume"] >= CLI_SLAM_FRAMES - CLI_CKPT_EVERY,
           "the resumed run did not go through cluster_labels on every "
           "frame")
    traj_a = np.loadtxt(out_a / "trajectory.txt")
    traj_b = np.loadtxt(out_b / "trajectory.txt")
    _check(traj_a.shape == traj_b.shape, "resumed trajectory shape")
    dtraj = float(np.abs(traj_a - traj_b).max())
    _log(f"cli slam --resume: trajectory differs from the uninterrupted "
         f"run by {dtraj:.3e}")
    _check(dtraj <= 1e-5, "the resumed trajectory differs by > 1e-5")
    # the written trajectory against the loop scene's ground truth
    gt = torch.from_numpy(swin["poses"][:len(traj_a)])
    est = torch.eye(4).repeat(len(traj_a), 1, 1)
    est[:, :3, :] = torch.from_numpy(traj_a.reshape(-1, 3, 4)).float()
    if len(traj_a) == CLI_SLAM_FRAMES:
        ate = float(odometry.ate_rmse(est, gt))
        _log(f"cli slam --data: ATE {ate:.5f} m over {len(traj_a)} "
             f"keyframes")
        _check(ate < 0.5, "cli slam ATE >= 0.5 m")

    # ---- the host's share of the --data path, the device idle: the whole
    # of what `slam --data` does to a scan before the engine sees it
    # (decode, down-sample, pad, upload), then the decode and the
    # down-sample alone
    args = argparse.Namespace(data=str(data), labels=None, start=0, end=0)
    eng = engine.SlamEngine(cfg, bench.slam_config(), device=dev)
    scans, n = cli.stream_scans(args, cfg)
    t0 = time.perf_counter()
    for scan in scans:
        eng._scan(*scan)
    torch.cuda.synchronize()
    scan_ms = (time.perf_counter() - t0) * 1e3 / n
    bins = io_kitti.sorted_frame_files(data, ".bin")[::cfg.skip]
    t0 = time.perf_counter()
    raw = list(prefetch.ScanPrefetcher(bins, None, max_points=4 * N,
                                       max_intensity=cfg.max_intensity))
    decode_ms = (time.perf_counter() - t0) * 1e3 / n
    t0 = time.perf_counter()
    kept = sum(int(io_kitti._voxel_downsample_np(xyz, 0.08).sum())
               for xyz, _, _ in raw)
    down_ms = (time.perf_counter() - t0) * 1e3 / n
    _log(f"cli slam --data: host decode + down-sample + pad + upload "
         f"{scan_ms:.3f} ms per scan over {n} scans; decode alone "
         f"{decode_ms:.3f} ms, 0.08 m down-sample alone {down_ms:.3f} ms "
         f"({kept // n} of {sum(len(r[0]) for r in raw) // n} points kept; "
         f"native prefetcher: {io_kitti._native() is not None})")
    shutil.rmtree(root)
    return launches


def loop_graph(F: int = 32, seed: int = 7) -> posegraph.PoseGraph:
    """tests/mp_worker.py:93-117's graph, built with the port's geometry: a
    1.5-turn helix of F poses, odometry with 0.02 noise per twist entry,
    exact loop edges 0-31 and 3-27."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1.5 * np.pi, F)
    gt = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    yaw = t + np.pi / 2
    gt[:, 0, 0], gt[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    gt[:, 1, 0], gt[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    gt[:, 0, 3], gt[:, 1, 3] = 5 * np.cos(t), 5 * np.sin(t)
    gt = torch.from_numpy(gt)
    noise = torch.from_numpy(rng.normal(0, 0.02, (F - 1, 6))
                             .astype(np.float32))
    rel = (geometry.inverse_se3(gt[:-1]) @ gt[1:]) @ geometry.exp_se3(noise)
    li, lj = torch.tensor([0, 3]), torch.tensor([F - 1, F - 5])
    lT = geometry.inverse_se3(gt[li]) @ gt[lj]
    return posegraph.make_odometry_graph(posegraph.odometry_chain(rel), rel,
                                         li, lj, lT, torch.ones(2))


def parallel_phase(dev, cfg, scene):
    """Phase 13: the parallel layer on a world of one rank under NCCL.
    Returns the cluster_labels launches of sharded_run_window."""
    N = cfg.shapes.max_points
    store = Path(tempfile.mkdtemp(prefix="nccl_store_"))
    pmesh.init_group(dev, 0, 1, f"file://{store / 'store'}")
    try:
        _check(dist.get_backend() == "nccl", "the group is not NCCL")
        win = synthetic.render_window(scene, F_TIME, N)
        xyz, inten, valid, poses = interop.window_from_numpy(win, dev)

        # ---- sharded_run_window against run_window, counting launches
        for k in KERNELS:
            k.launches = 0
        removed, states, n_dyn = sharded_pipeline.sharded_run_window(
            xyz, inten, valid, poses, cfg)
        torch.cuda.synchronize()
        launches = cl.cluster_labels.launches
        _check(launches == F_TIME, f"sharded_run_window launched "
               f"cluster_labels {launches} times over {F_TIME} frames")
        ref = pipeline.run_window(xyz, inten, valid, poses, cfg)
        j = F_TIME - 1
        _check(tuple(removed.shape) == (F_TIME, N)
               and tuple(states.shape) == (F_TIME, cfg.shapes.max_clusters),
               "sharded_run_window shapes")
        _check(torch.equal(n_dyn[:j], ref.n_dynamic[:j]) and int(n_dyn[j]) == 0,
               f"sharded n_dynamic {n_dyn.tolist()} against run_window's "
               f"{ref.n_dynamic.tolist()}")
        _check(torch.equal(removed[:j], ref.removed[:j]),
               "sharded removed differs from run_window's on frames 0..F-2")
        sharded_ms = _time_ms(lambda: sharded_pipeline.sharded_run_window(
            xyz, inten, valid, poses, cfg), TIME_REPS) / F_TIME
        single_ms = _time_ms(lambda: pipeline.run_window(
            xyz, inten, valid, poses, cfg), TIME_REPS) / F_TIME
        _log(f"sharded_run_window at one rank (NCCL): {sharded_ms:.3f} "
             f"ms/frame against run_window {single_ms:.3f} ms/frame "
             f"(F={F_TIME}, {TIME_REPS} reps, CUDA events); n_dynamic "
             f"{n_dyn.tolist()}, {launches} cluster_labels launches")

        # ---- tp_voxel_stats on frame 0 against the single-device sums
        vg = tensor_parallel.tp_voxel_stats(xyz[0], inten[0], valid[0],
                                            cfg.grid)
        _, flat, fov = quantize.quantize(xyz[0], valid[0], cfg.grid)
        g = cfg.grid.bin_num
        count = segment_ops.segment_sum(fov.float(), torch.where(fov, flat, g),
                                        g).to(torch.int32)
        _check(torch.equal(vg.count, count) and int(count.sum()) > 0,
               "tp_voxel_stats counts differ from the single-device sums")
        _log(f"tp_voxel_stats: counts identical on {g} voxels "
             f"({int((count > 0).sum())} occupied)")

        # ---- the stage pipeline at one stage, F = 3
        pp = pipeline_parallel.pipelined_process_window(
            xyz[:3], inten[:3], valid[:3], cfg)
        frames = pipeline.process_window(xyz[:3], inten[:3], valid[:3],
                                         poses[:3], cfg)
        st = frames.state
        for name, a, b in (
                ("point_voxel", pp.point_voxel, st.point_voxel),
                ("point_cluster", pp.point_cluster, st.point_cluster),
                ("label_grid", pp.label_grid, st.label_grid),
                ("valid", pp.table.valid, st.clusters.valid),
                ("type", pp.table.type, st.clusters.type),
                ("n_points", pp.table.n_points, st.clusters.n_points),
                ("n_clusters", pp.n_clusters, frames.n_clusters)):
            _check(torch.equal(a, b), f"pipelined_process_window {name} "
                   f"differs from process_window's")
        _log(f"pipelined_process_window: integer outputs identical on 3 "
             f"frames, n_clusters {pp.n_clusters.tolist()}")

        # ---- the two distributed pose-graph solves on the 32-node loop
        pg = loop_graph()
        pg = posegraph.PoseGraph(*(a.to(dev) for a in pg))
        err0 = float((posegraph.residuals(pg) ** 2).sum())
        want = posegraph.optimize(pg, gn_iters=PGO_GN, cg_iters=PGO_CG).poses
        solves = {
            "optimize_distributed": lambda: distributed_pgo
            .optimize_distributed(pg, gn_iters=PGO_GN, cg_iters=PGO_CG),
            "optimize_schur": lambda: schur_pgo.optimize_schur(pg,
                                                               gn_iters=8)}
        for (name, fn), atol in zip(solves.items(), PGO_ATOL):
            got, err = fn()
            diff = float((got - want).abs().max())
            _check(bool(torch.isfinite(got).all()) and float(err) < 0.25 * err0,
                   f"{name}: error {float(err)} against {err0} at the start")
            _check(diff <= atol, f"{name} differs from posegraph.optimize "
                   f"by {diff} > {atol}")
            _log(f"{name}: error {err0:.5f} -> {float(err):.6f}, "
                 f"{_time_ms(fn, TIME_REPS):.3f} ms per solve, poses within "
                 f"{diff:.3e} of posegraph.optimize ({PGO_GN} x {PGO_CG})")

        # ---- the scaling harness's one-rank row, the dry run
        rows = scaling.measure_scaling(xyz, inten, valid, poses, cfg,
                                       device_counts=[1], reps=TIME_REPS)
        _check(len(rows) == 1 and rows[0]["devices"] == 1
               and rows[0]["frames_per_s"] > 0
               and rows[0]["efficiency"] == 1.0, f"scaling rows {rows}")
        _log(f"measure_scaling one-rank row: {rows[0]}")
        dryrun.dryrun_multichip(1)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store)
    return launches


def stage_parts_phase(dev, cfg, scene):
    """Phase 14: the stage profiler's every component, the stage parts it
    reaches held against the pipeline's forms on frame 0, voxel_downsample,
    entry(), drive_e2e and the cascade's ours_window. Returns the kernel
    launches of the phase by kernel name."""
    t_phase = time.perf_counter()
    N, G, C = cfg.shapes.max_points, cfg.grid.bin_num, cfg.shapes.max_clusters
    seg = cfg.seg
    for k in KERNELS:
        k.launches = 0

    # ---- every component of the stage profiler
    prof = profile_stages.run(profile_stages.COMPONENTS, cfg, dev)
    torch.cuda.synchronize()
    _log(f"stage profiler: {len(prof)} timers; sub-stage table (ms): "
         f"{json.dumps(prof)}")

    # ---- the stage parts on frame 0's grid against the pipeline's forms
    win = synthetic.render_window(scene, 1, N)
    x0, i0, v0, _ = (t[0] for t in interop.window_from_numpy(win, dev))
    pw = patchwork.estimate_ground(x0, v0, cfg.patchwork)
    _, flat, in_fov = quantize.quantize(x0, pw.nonground, cfg.grid)
    grid, _ = quantize.voxel_stats_moments(flat, x0, i0, in_fov, cfg.grid)
    narrow = quantize.voxel_stats(flat, i0, in_fov, cfg.grid)
    _check(torch.equal(narrow.count, grid.count), "voxel_stats counts differ")
    stats_err = max(float((getattr(narrow, k) - getattr(grid, k)).abs().max())
                    for k in ("intensity_mean", "intensity_var"))
    _check(stats_err <= STATS_ATOL, f"voxel_stats mean / var differ from "
           f"voxel_stats_moments by {stats_err:.3e}")
    occ3 = grid.occupied.reshape(cfg.grid.shape)
    root = cl.cluster_labels(occ3, grid.intensity_mean, grid.intensity_var,
                             seg.search_c, seg.intensity_cov,
                             seg.intensity_diff, seg.far_range_frac)
    _, pc2, lg2, _, _ = clustering.compact_grid_labels(
        root, grid.occupied, flat, in_fov, C, G)
    point_roots = torch.where(in_fov, root[torch.clamp(flat, 0, G - 1).long()],
                              G)
    roots, pc, _, _ = clustering.compact_labels(point_roots, in_fov, C, G)
    lg = clustering.labels_to_grid(roots, root, grid.occupied, G)
    _check(torch.equal(lg, lg2) and torch.equal(pc, pc2),
           "compact_labels + labels_to_grid != compact_grid_labels")
    fix = dataclasses.replace(cfg, seg=dataclasses.replace(seg, iteration=24))
    refined = segmentation.refine_by_intensity(cc.cc_labels(occ3), grid, fix)
    _check(torch.equal(refined, root),
           "refine_by_intensity(iteration=24) != cluster_labels")
    res, point_voxel, fgrid = segmentation.segment_frame(
        x0, i0, pw.nonground, pw.ground, pw.dropped, cfg)
    planar = recognition.voxel_planarity(x0, point_voxel,
                                         res.point_cluster >= 0, cfg)
    used = res.label_grid >= 0
    _check(torch.equal(planar[used], res.planar_vox[used]),
           "voxel_planarity != voxel_planarity_from_moments on used voxels")
    want, _ = recognition.recognize(res.clusters, res.n_planar, cfg)
    for branch, extra in (("points", {}), ("grid", dict(
            label_grid=res.label_grid, voxel_count=fgrid.count))):
        got, _ = recognition.recognize_points(
            res.clusters, x0, res.point_cluster, point_voxel, cfg, **extra)
        _check(torch.equal(got.type, want.type), f"recognize's {branch} "
               f"fallback: types differ from the grid path")
    _log(f"stage parts on frame 0: compact_labels + labels_to_grid == "
         f"compact_grid_labels ({int(roots.ne(G).sum())} clusters), "
         f"voxel_stats within {stats_err:.3e} of voxel_stats_moments, "
         f"refine_by_intensity(24) == cluster_labels, planarity and both "
         f"recognition fallbacks equal the grid path "
         f"({int(want.type.ge(0).sum())} typed clusters)")

    # ---- voxel_downsample of a 131,072-point scan, card against CPU
    both = synthetic.render_window(scene, 2, N)
    pts = np.concatenate([both["xyz"][f][both["valid"][f]] for f in (0, 1)])
    pts = np.ascontiguousarray(pts[:DOWNSAMPLE_POINTS])
    _check(len(pts) == DOWNSAMPLE_POINTS, "too few points for the scan")
    xyz_d = torch.from_numpy(pts).to(dev)
    ok_d = torch.ones(len(pts), dtype=torch.bool, device=dev)
    keep = quantize.voxel_downsample(xyz_d, ok_d, DOWNSAMPLE_LEAF)
    keep_cpu = quantize.voxel_downsample(torch.from_numpy(pts),
                                         ok_d.cpu(), DOWNSAMPLE_LEAF)
    _check(torch.equal(keep.cpu(), keep_cpu),
           "voxel_downsample keep-masks differ on the card and the CPU")
    dev_ms = _time_ms(lambda: quantize.voxel_downsample(
        xyz_d, ok_d, DOWNSAMPLE_LEAF), KERNEL_REPS)
    t0 = time.perf_counter()
    for _ in range(TIME_REPS):
        host_keep = io_kitti._voxel_downsample_np(pts, DOWNSAMPLE_LEAF)
    host_ms = (time.perf_counter() - t0) * 1e3 / TIME_REPS
    _log(f"voxel_downsample, {len(pts)} points at {DOWNSAMPLE_LEAF} m: card "
         f"{dev_ms:.4f} ms (CUDA events, {KERNEL_REPS} reps), "
         f"{int(keep.sum())} kept; the host's io_kitti._voxel_downsample_np "
         f"{host_ms:.3f} ms, {int(host_keep.sum())} kept")

    # ---- entry(): one call, one kernel-1 launch, equal to the CPU run
    fn, args = entry.entry()
    before = cl.cluster_labels.launches
    out = fn(*args)
    torch.cuda.synchronize()
    n_entry = cl.cluster_labels.launches - before
    _check(n_entry == 1, f"entry() launched cluster_labels {n_entry} times")
    ref = fn(*(a.cpu() for a in args))
    for name in ("label_grid", "point_voxel", "point_cluster", "point_route"):
        _check(torch.equal(getattr(out.state, name).cpu(),
                           getattr(ref.state, name)),
               f"entry(): {name} differs from the CPU run")
    for name in ("valid", "n_points", "n_voxels", "type"):
        _check(torch.equal(getattr(out.state.clusters, name).cpu(),
                           getattr(ref.state.clusters, name)),
               f"entry(): clusters.{name} differs from the CPU run")
    _check(int(out.n_clusters) == int(ref.n_clusters) > 0,
           "entry(): cluster counts differ")

    # ---- drive_e2e at full width on the card
    lines, _, m = drive_e2e.drive(dev)
    _log("drive_e2e: " + " | ".join(lines))
    _check(m.pr > 99.0 and m.rr > 96.0, "drive_e2e: PR > 99 / RR > 96 missed")

    # ---- the cascade's ours_window: card against the CPU
    ccfg = cascade_experiment.experiment_config()
    cwin, frames, pairs = cascade_experiment.prepare_frames(
        ccfg, CASCADE_FRAMES, device=dev)
    rem = cascade_experiment.ours_window(frames, ccfg, 0.5, cwin, device=dev)
    rem_cpu = cascade_experiment.ours_window(frames, ccfg, 0.5, cwin,
                                             device="cpu")
    _check(np.array_equal(rem, rem_cpu),
           "cascade ours_window differs on the card and the CPU")
    rem_o = cascade_experiment.oracle_window(frames, pairs, ccfg, 0.5)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in KERNELS}
    _log(f"cascade ({CASCADE_FRAMES} frames, occupancy 0.5): ours_window "
         f"removes {int(rem.sum())} points on the card and the CPU alike, "
         f"the in-loop oracle {int(rem_o.sum())}; phase 14 launches "
         f"{launches} in {time.perf_counter() - t_phase:.1f} s")
    return launches


def hard_scenes_phase(dev, cfg) -> int:
    """Phase 16, first part: the three stress scenes of
    tests/test_hard_scenes.py through run_window at full width on the card
    and on the CPU. Returns the cluster_labels launches on the card."""
    launches = 0
    for name, (spec, F) in HARD_SCENES.items():
        win = synthetic.render_window(
            synthetic.make_scene(synthetic.SceneSpec(**spec)), F,
            cfg.shapes.max_points)
        for k in KERNELS:
            k.launches = 0
        res = pipeline.run_window(*interop.window_from_numpy(win, dev), cfg)
        torch.cuda.synchronize()
        n = cl.cluster_labels.launches
        launches += n
        ref = pipeline.run_window(*interop.window_from_numpy(win, "cpu"),
                                  cfg)
        diff = card_vs_cpu(res, ref)
        m = metrics.removal_metrics(
            win["label"][:F - 1], res.removed[:F - 1].cpu().numpy(),
            win["valid"][:F - 1])
        _log(f"hard scene {name} (F = {F}): PR {m.pr:.4f} RR {m.rr:.4f}, "
             f"{int(res.removed.sum())} points removed, {n} cluster_labels "
             f"launches; card vs cpu port: entries that differ "
             f"{json.dumps(diff)} ({int(win['valid'].sum())} valid points)")
        _check(n == F, f"hard scene {name}: {n} cluster_labels launches for "
               f"{F} frames")
        _check(not any(diff.values()), f"hard scene {name}: the card's "
               f"run_window differs from the port's CPU run")
    return launches


def bench_launches(reps: int, frames: int, slam_frames: int,
                   window: int) -> dict:
    """The cluster_labels launches that each section of tools/bench.py makes
    at these arguments: one a frame that run_window, segment_frame or the
    engine processes."""
    n_more, rest = divmod(slam_frames - window, window - 1)
    return {
        "headline": (reps + 1) * frames,    # run_window: warm-up + reps
        # segment_frame and process_window build the stages' inputs, then
        # the segment stage's warm-up + reps
        "stages": 1 + frames + reps + 1,
        "roofline": reps + 1,               # graph_ms: warm-up + captured
        "trace": reps + 1,                  # the segment stage, profiled
        "odometry": 0,
        # every window runs its overlap frame again; a short last window
        # runs what is left at finalize()
        "slam": window * (1 + n_more) + (rest + 1 if rest else 0),
        "engine-trace": 2 * window,         # process_window: warm-up + one
    }


def bench_phase() -> int:
    """Phase 16, second part: tools/bench.py in a subprocess at its
    defaults. Returns its cluster_labels launches."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dr_using_scv_od_tpu_torch.tools.bench"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=BENCH_TIMEOUT)
    for line in proc.stderr.splitlines():
        _log(f"bench stderr: {line}")
    for line in proc.stdout.splitlines():
        _log(f"bench stdout: {line}")
    _check(proc.returncode == 0, f"tools/bench.py exited {proc.returncode}")
    lines = proc.stdout.splitlines()
    _check(len(lines) == 1, f"tools/bench.py printed {len(lines)} stdout "
           f"lines, not one")
    out = json.loads(lines[0])
    _check(set(out) == {"metric", "value", "unit", "vs_baseline", "device"},
           f"bench keys {sorted(out)}")
    _check(out["metric"] == "dynamic_removal_ms_per_frame"
           and out["unit"] == "ms/frame" and out["value"] > 0,
           f"bench line {out}")
    _check(out["device"] == torch.cuda.get_device_name(0),
           f"bench device {out['device']!r}")
    # both numbers are rounded to 3 decimals
    slack = 5e-4 + bench.BASELINE_MS * 5e-4 / (out["value"] - 5e-4) ** 2
    _check(abs(out["vs_baseline"] - bench.BASELINE_MS / out["value"])
           <= slack, f"vs_baseline {out['vs_baseline']} is not "
           f"{bench.BASELINE_MS} / {out['value']}")
    err = proc.stderr.splitlines()
    for prefix in BENCH_PREFIXES:
        _check(any(line.startswith(prefix) for line in err),
               f"tools/bench.py printed no {prefix} line")
    _check(not any("not measured (cpu)" in line for line in err),
           "tools/bench.py printed a CPU line on the card")
    kline = next(line for line in err if line.startswith("[kernels]"))
    counts = json.loads(kline[kline.index("{"):])
    want = bench_launches(bench.REPS, bench.F, bench.SLAM_FRAMES,
                          bench.slam_config().window)
    _log(f"bench: {time.perf_counter() - t0:.1f} s; cluster_labels launches "
         f"{json.dumps(counts)}, its calls imply {json.dumps(want)}")
    _check(counts == want, "tools/bench.py's kernel launches differ from "
           "what its calls imply")
    return sum(counts.values())


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test runs only on a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log(f"gpu: {smi}")
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")

    # ---- 2. build the three kernels in parallel
    t0 = time.perf_counter()
    libs = cuda_build.build_libraries("cluster_labels", "cc_labels",
                                      "ri3_labels")
    _log(f"built {', '.join(p.name for p in libs.values())} in "
         f"{time.perf_counter() - t0:.1f} s")

    # ---- 3. main path at full width, counting kernel launches
    cfg = config.semantickitti()
    N = cfg.shapes.max_points
    scene = synthetic.make_scene()
    win = synthetic.render_window(scene, F_CHECK, N)
    args = interop.window_from_numpy(win, dev)
    for k in KERNELS:
        k.launches = 0
    res = pipeline.run_window(*args, cfg)
    torch.cuda.synchronize()
    launches = cl.cluster_labels.launches
    _log(f"run_window: {launches} cluster_labels launches")
    _check(launches >= F_CHECK, "run_window did not go through the "
           "cluster_labels kernel on every frame")

    G = cfg.grid.bin_num
    C = cfg.shapes.max_clusters
    _check(tuple(res.removed.shape) == (F_CHECK, N), "removed shape")
    _check(tuple(res.label_grids.shape) == (F_CHECK, G), "label_grids shape")
    _check(tuple(res.tables.bbox_min.shape) == (F_CHECK, C, 3), "table shape")
    live = res.tables.valid
    _check(bool(torch.isfinite(res.tables.bbox_min[live]).all()
                & torch.isfinite(res.tables.bbox_max[live]).all()),
           "non-finite bbox on a live cluster")
    _check(int(res.new_row_overflow) == 0, "cluster rows overflowed")
    m = m_judged = metrics.removal_metrics(
        win["label"][:F_CHECK - 1], res.removed[:F_CHECK - 1].cpu().numpy(),
        win["valid"][:F_CHECK - 1])
    _log(f"metrics: PR {m.pr:.4f} RR {m.rr:.4f} F1 {m.f1:.5f} "
         f"(static {m.n_static}, dynamic {m.n_dynamic})")
    _check(m.pr > 99.0 and m.rr > 96.0 and m.f1 > 0.97,
           "accuracy floors PR > 99 / RR > 96 / F1 > 0.97 missed")

    ref = pipeline.run_window(*interop.window_from_numpy(win, "cpu"), cfg)
    n_valid = int(win["valid"].sum())
    diff = card_vs_cpu(res, ref)
    _log(f"cuda vs cpu port: entries that differ {json.dumps(diff)} "
         f"({n_valid} valid points, {F_CHECK * G} label-grid voxels)")
    _check(not any(diff.values()),
           "the card's run_window differs from the port's CPU run")

    # ---- 4. kernel vs plain version, identical labels on every grid
    grids = res.frames.state.grid
    seg = cfg.seg
    cases = [(f"frame{f}", grids.count[f].reshape(cfg.grid.shape) > 0,
              grids.intensity_mean[f], grids.intensity_var[f],
              seg.search_c, seg.intensity_cov, seg.intensity_diff,
              seg.far_range_frac, True) for f in range(F_CHECK)]
    cases.append(("frame0-noshell",) + cases[0][1:-1] + (False,))
    cases += adversarial_grids(dev)
    max_err = 0
    for name, *case in cases:
        want = cl.cluster_labels_reference(*case).long()
        for _ in range(CHECK_REPS):
            got = cl.cluster_labels(*case)
            err = int((got.long() - want).abs().max())
            max_err = max(max_err, err)
            _check(err == 0,
                   f"{name}: kernel labels differ from the reference")
    labels = {c[0]: cl.cluster_labels(*c[1:]).cpu().numpy() for c in cases
              if c[0] in ("azimuth-wrap", "sector-seam")}
    wrap = labels["azimuth-wrap"]
    _check(wrap[np.ravel_multi_index((1, 5, 10), (6, 16, 64))]
           != wrap[np.ravel_multi_index((3, 5, 13), (6, 16, 64))],
           "azimuth wrap merged distant components")
    seam = labels["sector-seam"]
    _check(seam[np.ravel_multi_index((2, 5, 0), (6, 16, 64))]
           != seam[np.ravel_multi_index((2, 5, 63), (6, 16, 64))],
           "sector seam wrapped")
    _log(f"kernel == reference on {len(cases)} grids x {CHECK_REPS} "
         f"launches")

    # ---- 5. timing
    win6 = interop.window_from_numpy(
        synthetic.render_window(scene, F_TIME, N), dev)
    pipeline.run_window(*win6, cfg)                     # warm-up
    ms_frame = _time_ms(lambda: pipeline.run_window(*win6, cfg),
                        TIME_REPS) / F_TIME
    _log(f"run_window: {ms_frame:.3f} ms/frame "
         f"(F={F_TIME}, {TIME_REPS} reps after warm-up)")

    frame0 = cases[0][1:]
    cl.cluster_labels(*frame0)
    cl.cluster_labels_reference(*frame0)
    kernel_ms = _time_ms(lambda: cl.cluster_labels(*frame0), KERNEL_REPS)
    plain_ms = _time_ms(lambda: cl.cluster_labels_reference(*frame0),
                        TIME_REPS)
    _log(f"cluster_labels on the frame-0 grid {tuple(cfg.grid.shape)}: "
         f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms")
    G0, M0 = cfg.grid.bin_num, int(frame0[0].sum())
    device = {"cluster_labels": _device_ms(
        "cluster_labels", lambda: cl.cluster_labels(*frame0), G0, M0)}

    # ---- 6. kernels 2 and 3 against their plain versions, and the
    # identities that tie them to kernel 1
    errs = {"cluster_labels": 0, "cc_labels": 0, "ri3_labels": 0}

    def hold(name, kernel, plain, args):
        want = plain(*args).long()
        for _ in range(CHECK_REPS):
            err = int((kernel(*args).long() - want).abs().max())
            errs[kernel.__name__] = max(errs[kernel.__name__], err)
            _check(err == 0, f"{name}: {kernel.__name__} labels differ from "
                   f"the plain version")
        return want

    shape3 = tuple(cfg.grid.shape)
    ri3_args = (seg.search_c, seg.intensity_cov, seg.intensity_diff,
                seg.far_range_frac)
    for f in range(F_CHECK):
        occ3 = grids.count[f].reshape(shape3) > 0
        planes = (grids.count[f], grids.intensity_mean[f],
                  grids.intensity_var[f])
        root = hold(f"frame{f}", cc.cc_labels,
                    clustering.connected_components, (occ3,)).int()
        hold(f"frame{f}", ri3.ri3_labels, ri3.ri3_labels_reference,
             (root,) + planes + (shape3,) + ri3_args)
        fused = cl.cluster_labels(occ3, *planes[1:], *ri3_args)
        _check(torch.equal(ri3.ri3_labels(cc.cc_labels(occ3), *planes,
                                          shape3, *ri3_args), fused),
               f"frame{f}: ri3(cc(occ)) != cluster_labels(occ)")
        _check(torch.equal(cc.cc_labels(occ3), cl.cluster_labels(
            occ3, *planes[1:], *ri3_args, enable_shell=False)),
            f"frame{f}: cc(occ) != cluster_labels(occ, enable_shell=False)")
        if f == 0:
            ri3_frame0 = (root,) + planes + (shape3,) + ri3_args
    ccs, ri3s = cc_cases(), ri3_cases()
    for name, occ in ccs:
        hold(name, cc.cc_labels, clustering.connected_components,
             (torch.as_tensor(occ, device=dev),))
    for name, occ, av, var, far, merge, a, b in ri3s:
        occ3 = torch.as_tensor(occ, device=dev)
        args = (clustering.connected_components(occ3),
                occ3.reshape(-1).int(),
                torch.as_tensor(av.reshape(-1), device=dev),
                torch.as_tensor(var.reshape(-1), device=dev),
                occ.shape, 2, 1.0, 2.0, far)
        lab = hold(name, ri3.ri3_labels, ri3.ri3_labels_reference, args)
        ia, ib = (np.ravel_multi_index(v, occ.shape) for v in (a, b))
        _check(bool(lab[ia] == lab[ib]) == merge,
               f"{name}: voxels {a} and {b} "
               f"{'did not merge' if merge else 'merged'}")
    # any input: labels that are no CC fixpoint (a random permutation)
    gen = torch.Generator(device="cpu").manual_seed(0)
    perm = torch.randperm(cfg.grid.bin_num, generator=gen).to(dev).int()
    hold("frame0-permuted-labels", ri3.ri3_labels, ri3.ri3_labels_reference,
         (perm,) + ri3_frame0[1:])
    _log(f"cc_labels and ri3_labels == plain on {F_CHECK} frame grids, "
         f"{len(ccs)} CC cases, {len(ri3s) + 1} RI3 cases x "
         f"{CHECK_REPS} launches; identities hold on every frame grid")

    # ---- 7. the stage profiler's path through the three kernels
    for k in KERNELS:
        k.launches = 0
    prof = profile_stages.run(("cc", "ri3", "fused", "gicp"), cfg, dev)
    torch.cuda.synchronize()
    prof_launches = {k.__name__: k.launches for k in KERNELS}
    _log(f"profiler path launches: {prof_launches}; ms: {json.dumps(prof)}")
    for name, n in prof_launches.items():
        _check(n >= 1, f"the profiler path did not launch {name}")

    # ---- 8. odometry at full width, and run_window on estimated poses
    owin = synthetic.render_window(scene, F_ODOM, N)
    oxyz, ointen, ovalid, oposes = interop.window_from_numpy(owin, dev)
    s2s = odometry.estimate_window_poses(oxyz, ovalid, cfg)
    ate_s2s = float(odometry.ate_rmse(s2s.poses, oposes))
    s2m = odometry.estimate_window_poses_scan_to_map(oxyz, ovalid, cfg)
    ate_s2m = float(odometry.ate_rmse(s2m.poses, oposes))
    _log(f"odometry: scan-to-scan ATE {ate_s2s:.5f} m, n_corr "
         f"{s2s.n_corr.tolist()}; scan-to-map ATE {ate_s2m:.5f} m")
    _check(ate_s2s < 0.15, "scan-to-scan ATE >= 0.15 m")
    _check(bool((s2s.n_corr > 5000).all()), "a pair has <= 5000 "
           "correspondences")
    _check(ate_s2m < 0.05, "scan-to-map ATE >= 0.05 m")
    est = pipeline.run_window(oxyz, ointen, ovalid, s2s.poses, cfg)
    m = metrics.removal_metrics(owin["label"][:F_ODOM - 1],
                                est.removed[:F_ODOM - 1].cpu().numpy(),
                                owin["valid"][:F_ODOM - 1])
    _log(f"run_window on estimated poses: PR {m.pr:.4f} RR {m.rr:.4f} "
         f"F1 {m.f1:.5f}")
    _check(m.pr > 98.0 and m.rr > 70.0, "PR > 98 / RR > 70 missed on "
           "estimated poses")
    cwin = interop.window_from_numpy(owin, "cpu")
    pose_err = max(
        float((s2s.poses.cpu() - odometry.estimate_window_poses(
            cwin[0], cwin[2], cfg).poses).abs().max()),
        float((s2m.poses.cpu() - odometry.estimate_window_poses_scan_to_map(
            cwin[0], cwin[2], cfg).poses).abs().max()))
    _log(f"odometry poses, card vs cpu: max abs diff {pose_err:.3e}")
    _check(pose_err < POSE_ATOL, f"card and cpu poses differ by >= "
           f"{POSE_ATOL}")
    ms_pair = _time_ms(lambda: odometry.estimate_window_poses(
        oxyz, ovalid, cfg), TIME_REPS) / (F_ODOM - 1)
    ms_pair_s2m = _time_ms(lambda: odometry.estimate_window_poses_scan_to_map(
        oxyz, ovalid, cfg), TIME_REPS) / (F_ODOM - 1)
    _log(f"odometry: {ms_pair:.3f} ms per registered pair (scan-to-scan), "
         f"{ms_pair_s2m:.3f} ms (scan-to-map), F={F_ODOM}, {TIME_REPS} reps")

    # ---- 9. kernels 2 and 3 beside their plain versions, frame-0 grid
    occ0 = frame0[0]
    timed = {}
    for name, kernel, plain, args in (
            ("cc_labels", cc.cc_labels, clustering.connected_components,
             (occ0,)),
            ("ri3_labels", ri3.ri3_labels, ri3.ri3_labels_reference,
             ri3_frame0)):
        kernel(*args)
        plain(*args)
        timed[name] = (_time_ms(lambda: kernel(*args), KERNEL_REPS),
                       _time_ms(lambda: plain(*args), TIME_REPS))
        _log(f"{name} on the frame-0 grid: kernel {timed[name][0]:.4f} ms, "
             f"plain {timed[name][1]:.4f} ms")
        device[name] = _device_ms(name, lambda: kernel(*args), G0, M0)
    timed["cluster_labels"] = (kernel_ms, plain_ms)

    # ---- 10. the streaming SLAM engine at full width
    slam_launches, slam_ms = slam_phase(dev, cfg)

    # ---- 11. the kernels on full-size seam grids of the tile plan
    n_seam = n_seam_cc = 0
    for shape in SEAM_SHAPES:
        for name, occ, av, var in tile_plan.seam_grids(
                shape, seg.search_c, seg.intensity_cov, seg.intensity_diff):
            occ3 = torch.as_tensor(occ, device=dev)
            av, var = (torch.as_tensor(x, device=dev) for x in (av, var))
            args = (occ3, av, var, seg.search_c, seg.intensity_cov,
                    seg.intensity_diff, seg.far_range_frac)
            hold(f"seam {shape} {name}", cl.cluster_labels,
                 cl.cluster_labels_reference, args)
            hold(f"seam {shape} {name}", ri3.ri3_labels,
                 ri3.ri3_labels_reference,
                 (clustering.connected_components(occ3),
                  occ3.reshape(-1).int(), av, var, shape) + ri3_args)
            n_seam += 1
        for name, occ, _, _ in tile_plan.seam_grids(
                shape, 1, seg.intensity_cov, seg.intensity_diff):
            hold(f"seam {shape} {name}", cc.cc_labels,
                 clustering.connected_components,
                 (torch.as_tensor(occ, device=dev),))
            n_seam_cc += 1
    _log(f"cluster_labels and ri3_labels == plain on {n_seam} full-size seam "
         f"grids, cc_labels on {n_seam_cc}, x {CHECK_REPS} launches")

    # ---- 12. the command-line entry points at full width
    cli_launches = cli_phase(dev, cfg, res, ref, m_judged, scene)

    # ---- 13. the parallel layer at one rank under NCCL
    sharded_launches = parallel_phase(dev, cfg, scene)

    # ---- 14. the stage profiler's components, the stage parts and tools
    parts_launches = stage_parts_phase(dev, cfg, scene)

    # ---- 15. the engine's long gated trajectory and its two guards
    scale_launches = scale_phase(dev, slam_ms)

    # ---- 16. the stress scenes, card against CPU; the port's bench
    hard_launches = hard_scenes_phase(dev, cfg)
    bench_total = bench_phase()

    # cluster_labels: launches of the engine's path (phase 10); phase 3
    # counted run_window's, phase 12 the entry points' and phase 13 the
    # sharded window's
    _log(f"cluster_labels launches: run_window {launches}, engine "
         f"{slam_launches}, entry points {cli_launches}, sharded window "
         f"{sharded_launches}, stage parts and tools "
         f"{parts_launches['cluster_labels']}, long gated runs "
         f"{scale_launches}, stress scenes {hard_launches}, bench "
         f"{bench_total}")
    # each kernel's launches on the engine's path (kernel 1: phase 10,
    # both runs of phase 15 and phase 16's bench) or the stage profiler's
    # (kernels 2 and 3, phase 7), plus phase 14's
    launch_counts = {"cluster_labels": slam_launches
                     + sum(scale_launches.values()) + bench_total,
                     "cc_labels": prof_launches["cc_labels"],
                     "ri3_labels": prof_launches["ri3_labels"]}
    for name, n in parts_launches.items():
        launch_counts[name] += n
    errs["cluster_labels"] = max(errs["cluster_labels"], max_err)
    replaces = {
        "cluster_labels": "dr_using_scv_od_tpu/ops/pallas/fused_seg.py:56",
        "cc_labels": "dr_using_scv_od_tpu/ops/pallas/cc_kernel.py:49",
        "ri3_labels": "dr_using_scv_od_tpu/ops/pallas/ri3_kernel.py:52",
    }
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"dr_using_scv_od_tpu_torch/csrc/{name}.cu",
        "replaces": replaces[name],
        "launches": launch_counts[name],
        "max_abs_err": errs[name],
        "ms": timed[name][0],
        "plain_ms": timed[name][1],
        "device_ms": device[name],
        "bound_ms": kernel_times.bound_ms(name, G0, M0),
        "bound_by": "bytes",
        "share_of_bound": kernel_times.bound_ms(name, G0, M0) / device[name],
        "library_ms": None,
    } for name in replaces]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
