"""Offline analysis reports: intensity-dump histograms, per-class feature
statistics, stage-timing summaries.

Analogs of the reference's ad-hoc analysis scripts, driven by live data
instead of hard-coded numbers:
  * tool/readIntensity.py - histograms of the per-voxel intensity
    mean/variance dumps written by recordIntensity (src/ssc.cpp:1550-1587).
    The reference script iterates the file character-by-character (a bug);
    here the tab-separated floats are parsed properly.
  * tool/feature.py - boxplot statistics of seven geometric features
    (planarity, linearity, scattering, orientation, max/min height, scale)
    across recognized object classes. The reference hard-codes the values
    (tool/feature.py:17-24); here they are computed from actual clusters.
  * tool/time.py - per-stage timing summary from the StageTimer log (the
    reference fabricates two of its curves, tool/time.py:143-148; this one
    reports only measured stages).

These are host-side numpy reports (offline tooling, not the device path).

A copy of dr_using_scv_od_tpu/eval/reports.py (numpy and json only), held
equal to it by tests/test_torch_reports.py.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

FEATURE_NAMES = ["planarity", "linearity", "scattering", "orientation",
                 "max_height", "min_height", "scale"]
CLASS_NAMES = {0: "building", 1: "tree", 2: "car"}


# ---------------------------------------------------------------- intensity

def read_intensity_dump(prefix: str | Path) -> Tuple[np.ndarray, np.ndarray]:
    """Parse the ``<prefix>_av.txt`` / ``<prefix>_cov.txt`` pair written by
    utils.artifacts.record_intensity into float arrays."""
    def _read(path: Path) -> np.ndarray:
        toks = path.read_text().split()
        return np.asarray([float(t) for t in toks], np.float32)
    prefix = str(prefix)
    return _read(Path(prefix + "_av.txt")), _read(Path(prefix + "_cov.txt"))


def intensity_histogram(values: np.ndarray, bins: int = 10
                        ) -> Dict[str, np.ndarray]:
    """Histogram + summary stats of a per-voxel intensity dump
    (tool/readIntensity.py's plot, as data)."""
    counts, edges = np.histogram(values, bins=bins)
    return {
        "counts": counts,
        "edges": edges,
        "mean": float(values.mean()) if len(values) else 0.0,
        "std": float(values.std()) if len(values) else 0.0,
        "n": int(len(values)),
    }


# ----------------------------------------------------------------- features

def cluster_feature_matrix(xyz: np.ndarray, point_cluster: np.ndarray,
                           n_clusters: int) -> np.ndarray:
    """[C, 7] per-cluster geometric features in FEATURE_NAMES order.

    Eigen features come from the per-cluster covariance (the commented-out
    formulas of getDescriptorByEigenValue, src/ssc.cpp:688-721); orientation
    is the angle (rad) between the cluster's plane normal (smallest-eigval
    eigenvector) and +z; scale is the bbox diagonal length.
    """
    C = n_clusters
    feats = np.zeros((C, 7), np.float32)
    for c in range(C):
        sel = point_cluster == c
        pts = xyz[sel]
        if len(pts) < 3:
            continue
        mu = pts.mean(axis=0)
        d = pts - mu
        cov = d.T @ d / len(pts)
        evals, evecs = np.linalg.eigh(cov)       # ascending
        e3, e2, e1 = np.maximum(evals, 1e-12)
        s = e1 + e2 + e3
        e1, e2, e3 = e1 / s, e2 / s, e3 / s
        normal = evecs[:, 0]
        cosang = abs(normal[2]) / max(np.linalg.norm(normal), 1e-12)
        bb = pts.max(axis=0) - pts.min(axis=0)
        feats[c] = [
            (e2 - e3) / e1,                       # planarity
            (e1 - e2) / e1,                       # linearity
            e3 / e1,                              # scattering
            float(np.arccos(np.clip(cosang, -1.0, 1.0))),  # orientation
            float(pts[:, 2].max()),               # max height
            float(pts[:, 2].min()),               # min height
            float(np.linalg.norm(bb)),            # scale
        ]
    return feats


def per_class_feature_stats(xyz: np.ndarray, point_cluster: np.ndarray,
                            cluster_type: np.ndarray, n_clusters: int,
                            cluster_valid: Optional[np.ndarray] = None
                            ) -> Dict[str, Dict[str, Dict[str, float]]]:
    """class -> feature -> {mean, std, min, max, n} over valid clusters
    (tool/feature.py's boxplots, as data)."""
    feats = cluster_feature_matrix(xyz, point_cluster, n_clusters)
    npts = np.bincount(point_cluster[point_cluster >= 0],
                       minlength=n_clusters)
    ok = npts >= 3
    if cluster_valid is not None:
        ok &= np.asarray(cluster_valid[:n_clusters], bool)
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for cls, name in CLASS_NAMES.items():
        rows = feats[ok & (np.asarray(cluster_type[:n_clusters]) == cls)]
        if not len(rows):
            continue
        out[name] = {
            f: {"mean": float(rows[:, i].mean()),
                "std": float(rows[:, i].std()),
                "min": float(rows[:, i].min()),
                "max": float(rows[:, i].max()),
                "n": int(len(rows))}
            for i, f in enumerate(FEATURE_NAMES)
        }
    return out


# ------------------------------------------------------------------- timing

def parse_time_log(path: str | Path,
                   stage_names: Optional[Sequence[str]] = None
                   ) -> Dict[str, object]:
    """Summarize a StageTimer log. Accepts either the JSON dump (named
    stages) or the tab-separated per-frame text log (the reference's
    out/time4.txt shape, src/ssc.cpp:33)."""
    path = Path(path)
    text = path.read_text()
    if text.lstrip().startswith("{"):
        data = json.loads(text)
        rows: List[Dict[str, float]] = data["rows"]
    else:
        rows = []
        for line in text.splitlines():
            vals = [float(t) for t in line.split() if t]
            if not vals:
                continue
            names = (list(stage_names) if stage_names
                     else [f"stage{i}" for i in range(len(vals))])
            rows.append(dict(zip(names, vals)))
    if not rows:
        return {"rows": [], "summary": {}, "total_ms": 0.0}
    keys = list(rows[0].keys())
    summary = {k: float(np.mean([r.get(k, 0.0) for r in rows]))
               for k in keys}
    return {"rows": rows, "summary": summary,
            "total_ms": float(sum(summary.values()))}
