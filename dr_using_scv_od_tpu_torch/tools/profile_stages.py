"""Component-level timing of the port: each stage of the segmentation and
odometry paths, and the steps inside them, timed on their own on one
device (counterpart of tools/profile_stages.py).

    python -m dr_using_scv_od_tpu_torch.tools.profile_stages \
        [--device cuda] [--reps 8] [--split] [component ...]

Components (default: all), each timing the work of the JAX tool's
component of the same name:
  quantize     quantize + voxel_stats (the three narrow sums)
  cc ri3 fused the three hand-written label kernels (ops/cc_labels.py,
               ops/ri3_labels.py, ops/cluster_labels.py)
  widestats    quantize + voxel_stats_moments (the [N, 12] sum)
  compact2     compact_grid_labels
  compact      compact_labels + labels_to_grid
  segrest      segment_frame
  patchwork    estimate_ground, and its patch ids, z histogram and one
               plane fit's sums
  segparts     segment_frame's steps after the kernel
  recog        recognize from the points (voxel_planarity on its own too)
  track        track_window over 6 frames
  compactparts the cumsum, gathers and scatter of the compaction
  recogparts   recognition's planar count and feature arithmetic
  segparts2    the bbox min / max / count and the voxel histogram
  trackparts   the steps of one tracking pair, and tracking._pair_step
  gicp         build_voxel_map, finalize_target, one Gauss-Newton pass
               (max_iters=1: one correspondence pass of inner_iters steps,
               as the JAX tool's "1 GN iter") and register_pyramid

Where a JAX timer measures a TPU-only form of a step, the line times the
port's own form of that step and its name says so: "cumsum [G]" for
`_cumsum_matmul`, `torch.searchsorted` for the compare_all rank, the
bincount histograms for the one-hot matmuls, a sort for argsort, the
one-pass [N, F] segment sums of patchwork for its ten narrow sums. Two
JAX timers have no counterpart: "bbox minmax bcast" times
`segment_minmax_bcast`, a broadcast compare standing in for the TPU's slow
scatter, which the port does not have (`segment_minmax` is one scatter per
bound); and the component `ccrounds` times the TPU kernels at each
`max_outer` round cap, which the port's kernels do not have: every launch
reaches the fixpoint. `run` raises on `ccrounds` as on any unknown name.

Inputs are built as the JAX tool builds them: frame 0 (frame 1 as the GICP
source, frames 0-1 as the tracking pair) of the 6-frame synthetic window at
the config.semantickitti() width. Each timed call runs once as a warm-up,
then `reps` times between two CUDA events (the host clock on a CPU
device); one line per timer in the JAX tool's format. `--split` adds,
under each timer, its device time per call and the part of it in
`segment_reduce` kernels (torch.profiler over `reps` more calls; a card
only). The device must exist: there is no fallback.
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
from ..ops import (cc_labels, cluster_labels, clustering, geometry, quantize,
                   ri3_labels, segment_ops)
from ..types import TYPE_CAR, take
from ..utils import synthetic
from . import kernel_times

COMPONENTS = ("quantize", "cc", "ri3", "fused", "widestats", "compact2",
              "compact", "segrest", "patchwork", "segparts", "recog",
              "track", "compactparts", "recogparts", "segparts2",
              "trackparts", "gicp")


def require_device(device: torch.device | str) -> torch.device:
    """The device, or raise if this process cannot use it."""
    device = torch.device(device)
    if device.type == "cuda" and (
            not torch.cuda.is_available()
            or (device.index or 0) >= torch.cuda.device_count()):
        raise RuntimeError(f"device {device} is not available")
    return device


def timeit(name: str, fn: Callable, device: torch.device, reps: int,
           out: Dict[str, float], split: bool = False) -> None:
    """ms per call of fn() on `device` into out[name], and one line. With
    `split` (a card only), a second line gives the device time per call
    (torch.profiler) and the part of it in segment_reduce kernels, into
    out[name + " segment_reduce"]."""
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
    if split:
        busy, kernels = kernel_times.device_ms(fn, reps)
        seg = sum(v for k, v in kernels.items() if "segment_reduce" in k)
        out[name + " segment_reduce"] = seg
        print(f"    device {busy:.3f} ms, segment_reduce {seg:.3f} ms "
              f"({100 * seg / busy:.1f} %)", flush=True)


def run(components: Iterable[str], cfg: PipelineConfig,
        device: torch.device | str, reps: int = 8,
        split: bool = False) -> Dict[str, float]:
    """Time the named components on `device`; returns ms per call by the
    printed name. `split` adds each timer's segment_reduce device time
    (torch.profiler; a card only)."""
    which = set(components)
    unknown = which - set(COMPONENTS)
    if unknown:
        raise ValueError(f"unknown components {sorted(unknown)}")
    device = require_device(device)
    if split and device.type != "cuda":
        raise ValueError("split needs a CUDA device")
    out: Dict[str, float] = {}

    def time_(name, fn):
        timeit(name, fn, device, reps, out, split)

    win = synthetic.render_window(synthetic.make_scene(), 6,
                                  cfg.shapes.max_points)
    xyz, inten, valid, poses = interop.window_from_numpy(win, device)
    x0, i0, v0 = xyz[0], inten[0], valid[0]
    shape3 = cfg.grid.shape
    seg = cfg.seg
    G, C = cfg.grid.bin_num, cfg.shapes.max_clusters
    pw = patchwork.estimate_ground(x0, v0, cfg.patchwork)
    _, flat, in_fov = quantize.quantize(x0, pw.nonground, cfg.grid)
    grid, moments = quantize.voxel_stats_moments(flat, x0, i0, in_fov,
                                                 cfg.grid)
    occ3 = grid.occupied.reshape(shape3)

    if "quantize" in which:
        def quantize_stats():
            _, f, fov = quantize.quantize(x0, pw.nonground, cfg.grid)
            return quantize.voxel_stats(f, i0, fov, cfg.grid)
        time_("quantize+voxel_stats", quantize_stats)

    if "cc" in which:
        time_("cc_labels", lambda: cc_labels.cc_labels(occ3))

    root = None
    if which & {"ri3", "compact", "compact2", "segparts", "compactparts"}:
        root = cc_labels.cc_labels(occ3)

    if "ri3" in which:
        time_("ri3_labels", lambda: ri3_labels.ri3_labels(
            root, grid.count, grid.intensity_mean, grid.intensity_var,
            shape3, seg.search_c, seg.intensity_cov, seg.intensity_diff,
            seg.far_range_frac))

    if "fused" in which:
        time_("fused cc+ri3 kernel", lambda: cluster_labels.cluster_labels(
            occ3, grid.intensity_mean, grid.intensity_var, seg.search_c,
            seg.intensity_cov, seg.intensity_diff, seg.far_range_frac))

    if "widestats" in which:
        def wide_stats():
            _, f, fov = quantize.quantize(x0, pw.nonground, cfg.grid)
            return quantize.voxel_stats_moments(f, x0, i0, fov, cfg.grid)
        time_("quantize+voxel_stats_moments", wide_stats)

    if "compact2" in which:
        time_("compact_grid_labels", lambda: clustering.compact_grid_labels(
            root, grid.occupied, flat, in_fov, C, G))

    if "compact" in which:
        def compact():
            point_roots = torch.where(
                in_fov, root[torch.clamp(flat, 0, G - 1).long()], G)
            roots, point_cluster, _, _ = clustering.compact_labels(
                point_roots, in_fov, C, G)
            return roots, point_cluster, clustering.labels_to_grid(
                roots, root, grid.occupied, G)
        time_("compact+grid", compact)

    def segment():
        return segmentation.segment_frame(x0, i0, pw.nonground, pw.ground,
                                          pw.dropped, cfg)

    if "segrest" in which:
        time_("segment_frame FULL", segment)

    if "patchwork" in which:
        _patchwork_parts(cfg, x0, v0, time_)

    if "segparts" in which:
        _, point_cluster, label_grid, _, _ = clustering.compact_grid_labels(
            root, grid.occupied, flat, in_fov, C, G)
        time_("  planarity_from_moments",
              lambda: recognition.voxel_planarity_from_moments(
                  grid.count, moments, cfg))
        time_("  hist_multi (nvox/npts/nplanar) [bincount]",
              lambda: segment_ops.grid_label_hist_multi(
                  label_grid, C, [grid.count, grid.count // 2]))
        time_("  bbox minmax fused", lambda: segment_ops.segment_minmax(
            x0, point_cluster, point_cluster >= 0, C))
        table = torch.sort(torch.arange(C, dtype=torch.int32,
                                        device=device) * 997).values
        time_("  rank in compact [searchsorted]",
              lambda: torch.searchsorted(table, root, side="left"))
        time_("  cumsum [G]", lambda: torch.cumsum(
            grid.occupied.to(torch.int32), 0, dtype=torch.int32))

    seg_res = point_voxel = None
    if which & {"recog", "recogparts", "segparts2"}:
        seg_res, point_voxel, _ = segment()

    if "recog" in which:
        time_("recognize FULL", lambda: recognition.recognize_points(
            seg_res.clusters, x0, seg_res.point_cluster, point_voxel, cfg))
        time_("  voxel_planarity", lambda: recognition.voxel_planarity(
            x0, point_voxel, point_voxel >= 0, cfg))

    frames = None
    if which & {"track", "trackparts"}:
        frames = pipeline.process_window(xyz, inten, valid, poses, cfg)

    if "track" in which:
        point_voxel_w = frames.state.point_voxel
        time_("track_window (6 frames)", lambda: tracking.track_window(
            xyz, point_voxel_w, (point_voxel_w >= 0) & valid,
            frames.state.label_grid, frames.state.clusters, poses, cfg))

    if "compactparts" in which:
        _compact_parts(cfg, root, grid.occupied, flat, time_)

    if "recogparts" in which:
        pc = seg_res.point_cluster
        planar = recognition.voxel_planarity(x0, point_voxel, pc >= 0, cfg)

        def n_planar():
            pv_safe = torch.clamp(point_voxel, 0, G - 1).long()
            return segment_ops.segment_count(
                pc, (pc >= 0) & planar[pv_safe], C)
        time_("  planar gather+segcount", n_planar)

        def feature_math():
            t = seg_res.clusters
            n_pts = torch.clamp_min(t.n_points, 1)
            dx = t.bbox_max[:, 0] - t.bbox_min[:, 0]
            dy = t.bbox_max[:, 1] - t.bbox_min[:, 1]
            spread = (geometry.polar_angle_deg(t.bbox_max)
                      - geometry.polar_angle_deg(t.bbox_min)).abs()
            return dx * dy + spread + n_pts
        time_("  feature math", feature_math)

    if "segparts2" in which:
        pc = seg_res.point_cluster

        def bbox_reductions():
            return (segment_ops.segment_count(pc, pc >= 0, C),
                    segment_ops.segment_min(x0, pc, pc >= 0, C),
                    segment_ops.segment_max(x0, pc, pc >= 0, C))
        time_("  bbox seg min/max/count", bbox_reductions)
        time_("  grid_label_counts [bincount]",
              lambda: segment_ops.grid_label_counts(seg_res.label_grid, C))

    if "trackparts" in which:
        _track_parts(cfg, frames, xyz, valid, poses, time_)

    if "gicp" in which:
        gcfg = cfg.gicp
        time_("gicp build_voxel_map",
              lambda: gicp.build_voxel_map(x0, v0, gcfg))
        vm = gicp.build_voxel_map(x0, v0, gcfg)
        time_("gicp finalize_target", lambda: gicp.finalize_target(vm, gcfg))
        tgt = gicp.finalize_target(vm, gcfg)
        one = dataclasses.replace(gcfg, max_iters=1)
        time_("gicp 1 GN iter", lambda: gicp.register(
            xyz[1], valid[1], tgt, one).T)
        time_("gicp register_pyramid pair", lambda: gicp.register_pyramid(
            xyz[1], valid[1], vm, gcfg).T)
    return out


def _patchwork_parts(cfg: PipelineConfig, x0, v0, time_) -> None:
    """estimate_ground, then its patch ids, its z histogram and one plane
    fit's moment sums (each with the patch ids, as the JAX tool times
    them)."""
    pcfg = cfg.patchwork
    P = pcfg.num_patches
    time_("patchwork FULL", lambda: patchwork.estimate_ground(x0, v0, pcfg))
    time_("  patch_id", lambda: patchwork._patch_id(x0, v0, pcfg))
    time_("  z-histogram [N,256] segment_sum", lambda: patchwork._z_histogram(
        x0, patchwork._patch_id(x0, v0, pcfg), pcfg))

    def plane_fit_sums():
        pid = patchwork._patch_id(x0, v0, pcfg)
        return patchwork._psum(pid < P, patchwork._moment_feats(x0), pid, P)
    time_("  one plane-fit [N,10] segment_sum", plane_fit_sums)


def _compact_parts(cfg: PipelineConfig, root, occupied, flat, time_) -> None:
    """The compaction's steps on their own: the root count, the gathers of
    compact ids by root and by point, and the roots table."""
    G, C = cfg.grid.bin_num, cfg.shapes.max_clusters
    g_iota = torch.arange(G, dtype=torch.int32, device=root.device)

    def cumsum_only():
        is_root = occupied & (root == g_iota)
        return torch.cumsum(is_root.to(torch.int32), 0, dtype=torch.int32)
    time_("  cumsum(G)", cumsum_only)
    cid = cumsum_only() - 1
    time_("  gather cid[root] (G)", lambda: cid[root.long()])

    def scatter_roots():
        is_root = occupied & (root == g_iota)
        slot = torch.where(is_root & (cid < C), cid, C).long()
        return torch.full((C + 1,), G, dtype=torch.int32,
                          device=root.device).scatter(0, slot, g_iota)[:C]
    time_("  scatter roots", scatter_roots)
    time_("  point gather (N from G)",
          lambda: root[torch.clamp(flat, 0, G - 1).long()])


def _track_parts(cfg: PipelineConfig, frames, xyz, valid, poses,
                 time_) -> None:
    """One tracking pair (frames 0 -> 1) in its steps, each as
    tracking._pair_step computes it, then _pair_step whole."""
    G, C = cfg.grid.bin_num, cfg.shapes.max_clusters
    K = cfg.shapes.max_track_points
    device = xyz.device
    st = frames.state
    pv, lg0, lg1 = st.point_voxel[0], st.label_grid[0], st.label_grid[1]
    tab0, tab1 = take(st.clusters, 0), take(st.clusters, 1)
    T_np = geometry.inverse_se3(poses[1]) @ poses[0]
    pva = (pv >= 0) & valid[0]
    x = xyz[0]
    N = x.shape[0]
    k_iota = torch.arange(K, dtype=torch.int32, device=device)
    key_pad = torch.iinfo(torch.int64).max

    def budget():
        pc = torch.where(pva, lg0[torch.clamp(pv, 0, G - 1).long()], -1)
        is_car = tab0.valid & (tab0.type == TYPE_CAR)
        pt_car = (pc >= 0) & is_car[torch.clamp(pc, 0, C - 1).long()]
        rank = torch.cumsum(pt_car.to(torch.int32), 0, dtype=torch.int32) - 1
        total = pt_car.sum().to(torch.int32)
        stride = torch.clamp_min((total + K - 1) // K, 1)
        sel = pt_car & (rank % stride == 0)
        csel = torch.cumsum(sel.to(torch.int32), 0, dtype=torch.int32)
        idx = torch.clamp(torch.searchsorted(csel, k_iota + 1), 0, N - 1)
        ccar = k_iota < torch.clamp(csel[-1], max=K)
        return (torch.where(ccar[:, None], x[idx], 0.0),
                torch.where(ccar, pc[idx], -1), ccar)
    time_("  budget compaction [searchsorted]", budget)
    cxyz, cpc, ccar = budget()

    def warp_quantize():
        _, vflat, fov = quantize.quantize(
            geometry.transform_points(T_np, cxyz), ccar, cfg.grid)
        return vflat, fov
    time_("  warp+quantize(K)", warp_quantize)
    vflat, fov = warp_quantize()

    def dedup():
        nlab = torch.where(fov, lg1[torch.clamp(vflat, 0, G - 1).long()], -1)
        hit = fov & (nlab >= 0)
        key = torch.where(hit, cpc.long() * G + vflat.long(), key_pad)
        skey, order = torch.sort(key)
        return skey, order, nlab
    time_("  dedup sort(K)", dedup)

    def contingency():
        skey, order, nlab = dedup()
        uniq = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                          skey[1:] != skey[:-1]]) & (skey != key_pad)
        u_c = torch.where(uniq, cpc[order], C)
        u_l = torch.where(uniq, nlab[order], C)
        return torch.bincount((u_c * (C + 1) + u_l).long(),
                              minlength=(C + 1) ** 2)
    time_("  dedup+cont [bincount]", contingency)
    time_("  nvox over G [bincount]",
          lambda: segment_ops.grid_label_counts(lg1, C))
    zero = torch.zeros((), dtype=torch.int32, device=device)
    time_("  _pair_step FULL", lambda: tracking._pair_step(
        tab0, lg0, tab1, lg1, x, pv, pva, T_np, zero, cfg))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("components", nargs="*", metavar="component",
                    help=f"one of {' '.join(COMPONENTS)} (default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--split", action="store_true",
                    help="also each timer's device time and its part in "
                         "segment_reduce kernels (torch.profiler)")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name}), torch {torch.__version__}",
          flush=True)
    run(args.components or COMPONENTS, config.semantickitti(), device,
        args.reps, args.split)
    return 0


if __name__ == "__main__":
    sys.exit(main())
