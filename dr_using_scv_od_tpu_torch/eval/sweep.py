"""Parameter sweeps: occupancy-threshold sensitivity (counterpart of
dr_using_scv_od_tpu/eval/sweep.py).

Reproduces the reference's overlap-ratio experiment (doc/note.txt:81-101,
plotted by tool/plotPR.py): PR/RR as a function of the `occupancy`
threshold. The per-frame segmentation is shared across the sweep (the
reference re-ran the whole binary per point); the tracking + verdict stage
then runs once per threshold, a plain loop (occupancy is a scalar compare
in the verdict lattice)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch

from ..config import PipelineConfig
from ..models import pipeline as pipeline_mod
from ..models import tracking as tracking_mod
from ..types import STATE_DYNAMIC
from . import metrics


def occupancy_sweep(xyz: torch.Tensor, intensity: torch.Tensor,
                    valid: torch.Tensor, poses: torch.Tensor,
                    labels, cfg: PipelineConfig,
                    thresholds: Sequence[float] = (0.2, 0.4, 0.5, 0.6, 0.8),
                    judged_only: bool = True,
                    compensation: bool | None = None) -> List[Dict]:
    """Returns one {threshold, pr, rr, f1} row per occupancy value.
    `labels` is the [F, N] ground truth (array or tensor).

    `compensation`: override TrackingConfig.enable_compensation for the
    sweep (None keeps cfg's setting) - the "-TC" ablation axis the
    reference's own sensitivity study never separated (doc/note.txt:83-101).
    All other tracking settings of `cfg.track` are preserved per-row
    (dataclasses.replace, not a fresh TrackingConfig).
    """
    frames = pipeline_mod.process_window(xyz, intensity, valid, poses, cfg)
    pt_valid = (frames.state.point_voxel >= 0) & valid
    F = xyz.shape[0]
    G = cfg.grid.bin_num
    C = cfg.shapes.max_clusters
    pv_safe = torch.clamp(frames.state.point_voxel, 0, G - 1).long()

    cfg_t = cfg
    if compensation is not None:
        cfg_t = dataclasses.replace(
            cfg, track=dataclasses.replace(cfg.track,
                                           enable_compensation=compensation))

    labels = torch.as_tensor(labels).cpu().numpy()
    valid_np = valid.cpu().numpy()
    upto = F - 1 if judged_only else F
    rows = []
    for thr in thresholds:
        tr = tracking_mod.track_window(
            xyz, frames.state.point_voxel, pt_valid,
            frames.state.label_grid, frames.state.clusters, poses, cfg_t,
            occupancy=float(thr))
        pc = torch.where(pt_valid, tr.label_grids.gather(1, pv_safe), -1)
        st = tr.tables.state.gather(1, torch.clamp(pc, 0, C - 1).long())
        removed = (pc >= 0) & (st == STATE_DYNAMIC) & valid       # [F, N]
        m = metrics.removal_metrics(labels[:upto],
                                    removed[:upto].cpu().numpy(),
                                    valid_np[:upto])
        rows.append({"threshold": float(thr), "pr": m.pr, "rr": m.rr,
                     "f1": m.f1})
    return rows


def format_table(rows: List[Dict]) -> str:
    """Markdown table like BASELINE.md's sensitivity section."""
    out = ["| threshold | PR | RR | F1 |", "|---|---|---|---|"]
    for r in rows:
        out.append(f"| {r['threshold']:.1f} | {r['pr']:.2f} "
                   f"| {r['rr']:.2f} | {r['f1']:.4f} |")
    return "\n".join(out)
