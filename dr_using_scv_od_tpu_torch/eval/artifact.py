"""Artifact-level evaluation: PR/RR from saved PCD maps via nearest-
neighbour matching (counterpart of dr_using_scv_od_tpu/eval/artifact.py).

Twin of the reference's offline chain (tool/analysis.py:158-194 +
src/evaluate.cpp kd-radius matching), for evaluating maps produced by
external tools or earlier runs. The kd-tree 1-NN becomes a chunked
brute-force distance minimum: the distance block is one matrix product
(||a-b||^2 = |a|^2 + |b|^2 - 2 a.b), a plain `torch.matmul` on the device
the caller names: `device` is a required keyword of every function that
computes here.
"""

from __future__ import annotations

import numpy as np
import torch

from .metrics import DYNAMIC_CLASSES, is_dynamic_label


def nn_distances(query, ref, chunk: int = 4096, *,
                 device: torch.device | str) -> torch.Tensor:
    """For each query point, squared distance to the nearest ref point.
    query [N,3], ref [M,3] (arrays or tensors) -> [N] f32 on `device`,
    which the caller must name (nothing here picks the CPU by default).
    Chunked so that only a [chunk, M] distance block is live."""
    ref = torch.as_tensor(ref, dtype=torch.float32, device=device)
    query = torch.as_tensor(query, dtype=torch.float32, device=device)
    ref_sq = (ref * ref).sum(1)
    out = torch.empty(query.shape[0], dtype=torch.float32, device=device)
    for s in range(0, query.shape[0], chunk):
        q = query[s:s + chunk]
        q_sq = (q * q).sum(1, keepdim=True)
        d = q_sq + ref_sq[None, :] - 2.0 * (q @ ref.T)
        out[s:s + chunk] = d.min(1).values
    return out.clamp_(min=0.0)


def evaluate_maps(gt_xyz: np.ndarray, gt_labels: np.ndarray,
                  est_xyz: np.ndarray, voxel: float = 0.2, *,
                  device: torch.device | str):
    """PR/RR/F1 in the style of analysis.py's naive preservation: a gt
    point is 'preserved' if the estimated static map has a point within
    voxel*sqrt(3)/2 (tool/analysis.py:133)."""
    thr = voxel * np.sqrt(3.0) / 2.0
    d = nn_distances(gt_xyz, est_xyz, device=device).cpu().numpy()
    preserved = d < thr ** 2
    dyn = is_dynamic_label(gt_labels)
    n_sta = int((~dyn).sum())
    n_dyn = int(dyn.sum())
    pr = 100.0 * (preserved & ~dyn).sum() / max(n_sta, 1)
    rr = 100.0 * (~preserved & dyn).sum() / max(n_dyn, 1)
    f1 = 2 * (pr / 100) * (rr / 100) / max(pr / 100 + rr / 100, 1e-12)
    per_class = {}
    sem = gt_labels.astype(np.uint32) & 0xFFFF
    for c in DYNAMIC_CLASSES:
        m = sem == c
        if m.sum():
            per_class[c] = 100.0 * (~preserved & m).sum() / m.sum()
    return {"pr": pr, "rr": rr, "f1": f1, "n_static": n_sta,
            "n_dynamic": n_dyn, "per_class": per_class}


# ---------------------------------------------------------------------------
# 4-outcome visual evaluation map (ufo_evaluate, src/evaluate.cpp:79-145)

OUTCOME_DROPPED = -1   # matched neither map (the reference skips these)
OUTCOME_TP = 0         # GT static, found in the static map     -> green
OUTCOME_FN = 1         # GT static, only in the dynamic cloud   -> orange
OUTCOME_TN = 2         # GT dynamic, found in the dynamic cloud -> cyan
OUTCOME_FP = 3         # GT dynamic, only in the static map     -> pink
#                        (the reference's comment at evaluate.cpp:135 says
#                        "FN" for this branch too; it is semantically a
#                        false preservation, so we name it FP)

OUTCOME_COLORS = np.array([
    [0, 255, 127],     # TP  (evaluate.cpp:100-102)
    [255, 165, 0],     # FN  (evaluate.cpp:111-113)
    [0, 255, 255],     # TN  (evaluate.cpp:124-126)
    [255, 192, 203],   # FP  (evaluate.cpp:135-137)
], np.uint8)


def four_outcome_map(gt_xyz: np.ndarray, gt_static: np.ndarray,
                     static_xyz: np.ndarray, dynamic_xyz: np.ndarray,
                     r_primary: float = 0.15, r_secondary: float = 0.1,
                     *, device: torch.device | str):
    """Classify every GT point into TP/FN/TN/FP by radius-matching it
    against the estimated static map and dynamic cloud, reproducing
    src/evaluate.cpp:87-143: the expected map is probed first with the
    looser radius (0.15 m), the opposite map with the tighter one (0.1 m),
    and points matching neither are dropped from the visual.

    Returns (outcome [N] int8, xyzrgb [M,6] float32 colored cloud of the
    kept points, counts dict)."""
    n = len(gt_xyz)
    d_s = np.full((n,), np.inf, np.float32)
    d_d = np.full((n,), np.inf, np.float32)
    if len(static_xyz):
        d_s = nn_distances(gt_xyz, static_xyz, device=device).cpu().numpy()
    if len(dynamic_xyz):
        d_d = nn_distances(gt_xyz, dynamic_xyz, device=device).cpu().numpy()
    in_s_p = d_s < r_primary ** 2
    in_d_p = d_d < r_primary ** 2
    in_s_s = d_s < r_secondary ** 2
    in_d_s = d_d < r_secondary ** 2

    outcome = np.full((n,), OUTCOME_DROPPED, np.int8)
    gt_static = np.asarray(gt_static, bool)
    outcome[gt_static & in_s_p] = OUTCOME_TP
    outcome[gt_static & ~in_s_p & in_d_s] = OUTCOME_FN
    outcome[~gt_static & in_d_p] = OUTCOME_TN
    outcome[~gt_static & ~in_d_p & in_s_s] = OUTCOME_FP

    kept = outcome >= 0
    rgb = OUTCOME_COLORS[outcome[kept]].astype(np.float32)
    xyzrgb = np.concatenate([gt_xyz[kept].astype(np.float32), rgb], axis=1)
    counts = {name: int((outcome == code).sum())
              for name, code in [("tp", OUTCOME_TP), ("fn", OUTCOME_FN),
                                 ("tn", OUTCOME_TN), ("fp", OUTCOME_FP),
                                 ("dropped", OUTCOME_DROPPED)]}
    return outcome, xyzrgb, counts


def evaluate_map_cli(args) -> int:
    from ..utils import artifacts, io_kitti
    gt = io_kitti.read_pcd_xyzi(args.gt)
    est_s = io_kitti.read_pcd_xyzi(args.static)
    est_d = io_kitti.read_pcd_xyzi(args.dynamic)
    gt_static = ~is_dynamic_label(gt[:, 3].astype(np.uint32))
    _, xyzrgb, counts = four_outcome_map(
        gt[:, :3], gt_static, est_s[:, :3], est_d[:, :3],
        r_primary=args.radius, r_secondary=args.radius2,
        device=args.device)
    artifacts.write_colored_pcd(args.out, xyzrgb)
    print(f"TP={counts['tp']}  FN={counts['fn']}  TN={counts['tn']}  "
          f"FP={counts['fp']}  dropped={counts['dropped']} -> {args.out}")
    return 0


def evaluate_cli(args) -> int:
    from ..utils import io_kitti
    gt = io_kitti.read_pcd_xyzi(args.gt)
    est = io_kitti.read_pcd_xyzi(args.est)
    res = evaluate_maps(gt[:, :3], gt[:, 3].astype(np.uint32), est[:, :3],
                        voxel=args.voxel, device=args.device)
    print(f"PR={res['pr']:.2f}  RR={res['rr']:.2f}  F1={res['f1']:.4f}  "
          f"(static {res['n_static']}, dynamic {res['n_dynamic']})")
    for c, rr in sorted(res["per_class"].items()):
        print(f"  class {c}: RR={rr:.2f}%")
    return 0
