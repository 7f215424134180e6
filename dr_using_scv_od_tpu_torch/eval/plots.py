"""Figure generation: PR/RR sensitivity curves, per-class IoU bars, stage
timing breakdowns.

Analog of the reference's tool/plotPR.py, tool/plotIoU.py and tool/time.py
figures, driven by live sweep/metric outputs instead of hard-coded numbers
(the reference scripts duplicate doc/note.txt by hand; tool/time.py even
fabricates two of its curves, tool/time.py:143-148).

matplotlib is optional: every function degrades to returning the data it
would have plotted.

A copy of dr_using_scv_od_tpu/eval/plots.py, held equal to it by
tests/test_torch_reports.py, with one change: matplotlib is imported when
a function draws, not when the module loads, so that importing the port
never loads it (a machine may run the port without matplotlib installed).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, List, Optional

_HAS_MPL = importlib.util.find_spec("matplotlib") is not None


def _pyplot():
    """matplotlib.pyplot on the Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_pr_rr_sensitivity(rows: List[Dict], out: Optional[str | Path]
                           ) -> List[Dict]:
    """PR/RR vs occupancy threshold (tool/plotPR.py analog)."""
    if _HAS_MPL and out:
        plt = _pyplot()
        thr = [r["threshold"] for r in rows]
        fig, ax = plt.subplots(figsize=(5, 3.2))
        ax.plot(thr, [r["pr"] for r in rows], "o-", label="PR")
        ax.plot(thr, [r["rr"] for r in rows], "s-", label="RR")
        ax.set_xlabel("object overlap-ratio threshold")
        ax.set_ylabel("%")
        ax.legend()
        ax.grid(alpha=0.3)
        fig.tight_layout()
        fig.savefig(out, dpi=130)
        plt.close(fig)
    return rows


def plot_iou_bars(iou: Dict[int, float], names: Dict[int, str],
                  out: Optional[str | Path]) -> Dict[int, float]:
    """Per-class IoU bars (tool/plotIoU.py analog)."""
    if _HAS_MPL and out:
        plt = _pyplot()
        ks = sorted(iou)
        fig, ax = plt.subplots(figsize=(4.2, 3))
        ax.bar([names.get(k, str(k)) for k in ks], [iou[k] for k in ks])
        ax.set_ylabel("IoU %")
        ax.set_ylim(0, 100)
        fig.tight_layout()
        fig.savefig(out, dpi=130)
        plt.close(fig)
    return iou


def plot_feature_box(stats: Dict[str, Dict[str, Dict[str, float]]],
                     out: Optional[str | Path]
                     ) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Per-class feature mean±std bars (tool/feature.py analog, from live
    cluster data via eval.reports.per_class_feature_stats)."""
    if _HAS_MPL and out and stats:
        plt = _pyplot()
        feats = list(next(iter(stats.values())).keys())
        classes = list(stats)
        x = list(range(len(feats)))
        w = 0.8 / max(len(classes), 1)
        fig, ax = plt.subplots(figsize=(7, 3.2))
        for j, cls in enumerate(classes):
            mu = [stats[cls][f]["mean"] for f in feats]
            sd = [stats[cls][f]["std"] for f in feats]
            ax.bar([xi + j * w for xi in x], mu, w, yerr=sd,
                   capsize=2, label=cls)
        ax.set_xticks([xi + 0.4 for xi in x])
        ax.set_xticklabels(feats, rotation=30, ha="right", fontsize=7)
        ax.legend(fontsize=7)
        ax.grid(axis="y", ls="--", alpha=0.5)
        fig.tight_layout()
        fig.savefig(out, dpi=130)
        plt.close(fig)
    return stats


def plot_intensity_hist(hist: Dict, out: Optional[str | Path]) -> Dict:
    """Per-voxel intensity histogram (tool/readIntensity.py analog)."""
    if _HAS_MPL and out:
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(4.2, 3))
        edges = hist["edges"]
        ax.bar(edges[:-1], hist["counts"],
               width=(edges[1:] - edges[:-1]), align="edge")
        ax.set_xlabel("CVI intensity")
        ax.set_ylabel("voxels")
        fig.tight_layout()
        fig.savefig(out, dpi=130)
        plt.close(fig)
    return hist


def plot_stage_times(summary: Dict[str, float],
                     out: Optional[str | Path]) -> Dict[str, float]:
    """Average per-stage ms (tool/time.py analog, honest version)."""
    if _HAS_MPL and out:
        plt = _pyplot()
        ks = list(summary)
        fig, ax = plt.subplots(figsize=(5, 3))
        ax.bar(ks, [summary[k] for k in ks])
        ax.set_ylabel("ms / frame")
        ax.tick_params(axis="x", rotation=30)
        fig.tight_layout()
        fig.savefig(out, dpi=130)
        plt.close(fig)
    return summary
