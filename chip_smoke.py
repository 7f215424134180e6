#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (dr_using_scv_od_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):
  1. require CUDA, switch TF32 off, print the card's name and power limit;
  2. build csrc/cluster_labels.cu with nvcc for sm_90a;
  3. run the main path, run_window at the full semantickitti() width
     (N = 131,072 points, G = 1,296,000 voxels, C = 512 clusters) on a
     5-frame synthetic window, counting the kernel's launches, and hold
     PR > 99 / RR > 96 / F1 > 0.97 and the port's CPU result on the same
     window;
  4. hold the kernel against cluster_labels_reference (identical int32
     labels, in each of 10 launches) on every frame's grid and on
     adversarial grids;
  5. time run_window (ms/frame, 6-frame window) and the kernel beside its
     plain version on a full-size grid, with CUDA events.
The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from dr_using_scv_od_tpu_torch import config, interop
from dr_using_scv_od_tpu_torch.eval import metrics
from dr_using_scv_od_tpu_torch.models import pipeline
from dr_using_scv_od_tpu_torch.ops import cluster_labels as cl
from dr_using_scv_od_tpu_torch.utils import synthetic

F_CHECK = 5        # window judged against the accuracy floors
F_TIME = 6         # window timed (bench.py's shape)
TIME_REPS = 3
KERNEL_REPS = 20
CHECK_REPS = 10    # the atomics' order varies from launch to launch


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


def _time_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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

    # ---- 2. build
    t0 = time.perf_counter()
    lib = cl.build_library()
    _log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")

    # ---- 3. main path at full width, counting kernel launches
    cfg = config.semantickitti()
    N = cfg.shapes.max_points
    scene = synthetic.make_scene()
    win = synthetic.render_window(scene, F_CHECK, N)
    args = interop.window_from_numpy(win, dev)
    cl.cluster_labels.launches = 0
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
    m = metrics.removal_metrics(win["label"][:F_CHECK - 1],
                                res.removed[:F_CHECK - 1].cpu().numpy(),
                                win["valid"][:F_CHECK - 1])
    _log(f"metrics: PR {m.pr:.4f} RR {m.rr:.4f} F1 {m.f1:.5f} "
         f"(static {m.n_static}, dynamic {m.n_dynamic})")
    _check(m.pr > 99.0 and m.rr > 96.0 and m.f1 > 0.97,
           "accuracy floors PR > 99 / RR > 96 / F1 > 0.97 missed")

    ref = pipeline.run_window(*interop.window_from_numpy(win, "cpu"), cfg)
    n_valid = int(win["valid"].sum())
    n_removed_diff = int((res.removed.cpu() != ref.removed).sum())
    n_pc_diff = int((res.point_cluster.cpu() != ref.point_cluster).sum())
    _log(f"cuda vs cpu port: removed differs on {n_removed_diff}, "
         f"point_cluster on {n_pc_diff} of {n_valid} valid points")
    _check(n_removed_diff <= n_valid // 1000,
           "cuda and cpu runs of the port disagree on > 0.1 % of points")

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

    print(json.dumps({"kernels": [{
        "name": "cluster_labels",
        "route": "cuda",
        "source": "dr_using_scv_od_tpu_torch/csrc/cluster_labels.cu",
        "replaces": "dr_using_scv_od_tpu/ops/pallas/fused_seg.py:56",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
