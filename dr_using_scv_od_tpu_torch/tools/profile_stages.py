"""Component-level timing of the port: each stage of the segmentation and
odometry paths timed on its own, on one device (counterpart of
tools/profile_stages.py).

    python -m dr_using_scv_od_tpu_torch.tools.profile_stages \
        [--device cuda] [--reps 8] [component ...]

Components (default: all): quantize cc ri3 fused compact segrest patchwork
recog track gicp. `cc`, `ri3` and `fused` are the three hand-written label
kernels (ops/cc_labels.py, ops/ri3_labels.py, ops/cluster_labels.py);
`gicp` times build_voxel_map, finalize_target, one Gauss-Newton pass
(max_iters=1: one correspondence pass of inner_iters steps, as the JAX
tool's "1 GN iter") and register_pyramid on a frame pair.

Inputs are built as the JAX tool builds them: frame 0 (frame 1 as the GICP
source) of the 6-frame synthetic window at the config.semantickitti()
width. Each component runs once as a warm-up, then `reps` times between
two CUDA events (the host clock on a CPU device); one line per component in
the JAX tool's format. The device must exist: there is no fallback.

The TPU tool's ccrounds, compactparts and other *parts components do not
carry over: their knobs are the TPU kernels' max_outer and VMEM tiling.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Callable, Dict, Iterable

import torch

from .. import config, interop
from ..config import PipelineConfig
from ..models import (gicp, patchwork, pipeline, recognition, segmentation,
                      tracking)
from ..ops import cc_labels, cluster_labels, clustering, quantize, ri3_labels
from ..utils import synthetic

COMPONENTS = ("quantize", "cc", "ri3", "fused", "compact", "segrest",
              "patchwork", "recog", "track", "gicp")


def require_device(device: torch.device | str) -> torch.device:
    """The device, or raise if this process cannot use it."""
    device = torch.device(device)
    if device.type == "cuda" and (
            not torch.cuda.is_available()
            or (device.index or 0) >= torch.cuda.device_count()):
        raise RuntimeError(f"device {device} is not available")
    return device


def _time(name: str, fn: Callable, device: torch.device, reps: int,
          out: Dict[str, float]) -> None:
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    warm = time.perf_counter() - t0
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        ms = start.elapsed_time(end) / reps
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / reps
    out[name] = ms
    print(f"{name:<28} {ms:9.3f} ms   (warm-up {warm:.1f}s)", flush=True)


def run(components: Iterable[str], cfg: PipelineConfig,
        device: torch.device | str, reps: int = 8) -> Dict[str, float]:
    """Time the named components on `device`; returns ms per call by the
    printed name."""
    which = set(components)
    unknown = which - set(COMPONENTS)
    if unknown:
        raise ValueError(f"unknown components {sorted(unknown)}")
    device = require_device(device)
    out: Dict[str, float] = {}

    win = synthetic.render_window(synthetic.make_scene(), 6,
                                  cfg.shapes.max_points)
    xyz, inten, valid, poses = interop.window_from_numpy(win, device)
    x0, i0, v0 = xyz[0], inten[0], valid[0]
    shape3 = cfg.grid.shape
    seg = cfg.seg
    pw = patchwork.estimate_ground(x0, v0, cfg.patchwork)
    _, flat, in_fov = quantize.quantize(x0, pw.nonground, cfg.grid)
    grid, _ = quantize.voxel_stats_moments(flat, x0, i0, in_fov, cfg.grid)
    occ3 = grid.occupied.reshape(shape3)

    if "quantize" in which:
        def quantize_stats():
            _, f, fov = quantize.quantize(x0, pw.nonground, cfg.grid)
            return quantize.voxel_stats_moments(f, x0, i0, fov, cfg.grid)
        _time("quantize+voxel_stats_moments", quantize_stats, device, reps,
              out)

    if "cc" in which:
        _time("cc_labels", lambda: cc_labels.cc_labels(occ3), device, reps,
              out)

    root = None
    if which & {"ri3", "compact"}:
        root = cc_labels.cc_labels(occ3)

    if "ri3" in which:
        _time("ri3_labels", lambda: ri3_labels.ri3_labels(
            root, grid.count, grid.intensity_mean, grid.intensity_var,
            shape3, seg.search_c, seg.intensity_cov, seg.intensity_diff,
            seg.far_range_frac), device, reps, out)

    if "fused" in which:
        _time("fused cc+ri3 kernel", lambda: cluster_labels.cluster_labels(
            occ3, grid.intensity_mean, grid.intensity_var, seg.search_c,
            seg.intensity_cov, seg.intensity_diff, seg.far_range_frac),
            device, reps, out)

    if "compact" in which:
        _time("compact_grid_labels", lambda: clustering.compact_grid_labels(
            root, grid.occupied, flat, in_fov, cfg.shapes.max_clusters,
            cfg.grid.bin_num), device, reps, out)

    def segment():
        return segmentation.segment_frame(x0, i0, pw.nonground, pw.ground,
                                          pw.dropped, cfg)

    if "segrest" in which:
        _time("segment_frame FULL", segment, device, reps, out)

    if "patchwork" in which:
        _time("patchwork FULL", lambda: patchwork.estimate_ground(
            x0, v0, cfg.patchwork), device, reps, out)

    if "recog" in which:
        seg_res = segment()[0]
        _time("recognize FULL", lambda: recognition.recognize(
            seg_res.clusters, seg_res.n_planar, cfg), device, reps, out)

    if "track" in which:
        frames = pipeline.process_window(xyz, inten, valid, poses, cfg)
        point_voxel = frames.state.point_voxel
        _time("track_window (6 frames)", lambda: tracking.track_window(
            xyz, point_voxel, (point_voxel >= 0) & valid,
            frames.state.label_grid, frames.state.clusters, poses, cfg),
            device, reps, out)

    if "gicp" in which:
        gcfg = cfg.gicp
        _time("gicp build_voxel_map",
              lambda: gicp.build_voxel_map(x0, v0, gcfg), device, reps, out)
        vm = gicp.build_voxel_map(x0, v0, gcfg)
        _time("gicp finalize_target", lambda: gicp.finalize_target(vm, gcfg),
              device, reps, out)
        tgt = gicp.finalize_target(vm, gcfg)
        one = dataclasses.replace(gcfg, max_iters=1)
        _time("gicp 1 GN iter", lambda: gicp.register(
            xyz[1], valid[1], tgt, one).T, device, reps, out)
        _time("gicp register_pyramid pair", lambda: gicp.register_pyramid(
            xyz[1], valid[1], vm, gcfg).T, device, reps, out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("components", nargs="*", metavar="component",
                    help=f"one of {' '.join(COMPONENTS)} (default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)
    device = require_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name}), torch {torch.__version__}",
          flush=True)
    run(args.components or COMPONENTS, config.semantickitti(), device,
        args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
