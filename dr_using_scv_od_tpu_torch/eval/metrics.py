"""Dynamic-removal metrics in numpy (counterpart of
dr_using_scv_od_tpu/eval/metrics.py; reference tool/analysis.py:124-194,
src/plotObject.cpp:89-146). Point identity is kept end to end, so the
correspondence with ground truth is exact.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np

DYNAMIC_CLASSES = (252, 253, 254, 255, 256, 257, 258, 259)


class RemovalMetrics(NamedTuple):
    pr: float          # static preservation %
    rr: float          # dynamic rejection %
    f1: float
    n_static: int
    n_dynamic: int
    n_static_removed: int
    n_dynamic_removed: int


def is_dynamic_label(labels, dynamic_classes: Sequence[int] = DYNAMIC_CLASSES
                     ) -> np.ndarray:
    """Semantic label (lower 16 bits) in the dynamic set."""
    sem = np.asarray(labels).astype(np.uint32) & 0xFFFF
    return np.isin(sem, np.asarray(dynamic_classes, np.uint32))


def removal_metrics(gt_labels, removed, valid,
                    dynamic_classes: Sequence[int] = DYNAMIC_CLASSES
                    ) -> RemovalMetrics:
    """PR / RR / F1 over flattened arrays: PR = preserved static / static,
    RR = removed dynamic / dynamic (both in %), F1 their harmonic mean."""
    valid = np.asarray(valid, bool).reshape(-1)
    gt_dyn = is_dynamic_label(gt_labels, dynamic_classes).reshape(-1) & valid
    gt_sta = valid & ~gt_dyn
    removed = np.asarray(removed, bool).reshape(-1) & valid

    n_sta = int(gt_sta.sum())
    n_dyn = int(gt_dyn.sum())
    sta_removed = int((gt_sta & removed).sum())
    dyn_removed = int((gt_dyn & removed).sum())

    pr = 100.0 * (n_sta - sta_removed) / max(n_sta, 1)
    rr = 100.0 * dyn_removed / max(n_dyn, 1)
    p, r = pr / 100.0, rr / 100.0
    f1 = 2 * p * r / max(p + r, 1e-12)
    return RemovalMetrics(pr=pr, rr=rr, f1=f1, n_static=n_sta,
                          n_dynamic=n_dyn, n_static_removed=sta_removed,
                          n_dynamic_removed=dyn_removed)


def per_class_rejection(gt_labels: np.ndarray, removed: np.ndarray,
                        valid: np.ndarray,
                        dynamic_classes: Sequence[int] = DYNAMIC_CLASSES):
    """Per-dynamic-class rejection table (tool/analysis.py:163-171).
    Returns {class: (rejection %, n_remaining, n_all)}."""
    sem = gt_labels.astype(np.uint32) & 0xFFFF
    out = {}
    for c in dynamic_classes:
        m = (sem == c) & valid
        n_all = int(m.sum())
        if n_all == 0:
            continue
        n_remain = int((m & ~removed).sum())
        out[c] = (100.0 * (n_all - n_remain) / n_all, n_remain, n_all)
    return out


def semantic_iou(gt_labels: np.ndarray, pred_class: np.ndarray,
                 valid: np.ndarray,
                 class_map: Dict[int, Tuple[int, ...]]) -> Dict[int, float]:
    """Per-class IoU in the style of src/plotObject.cpp:89-146.

    class_map: predicted class id -> tuple of ground-truth semantic labels
    counted as that class.
    """
    sem = gt_labels.astype(np.uint32) & 0xFFFF
    out = {}
    for cls, gt_set in class_map.items():
        pred = (pred_class == cls) & valid
        gt = np.isin(sem, gt_set) & valid
        inter = float((pred & gt).sum())
        union = float((pred | gt).sum())
        out[cls] = 100.0 * inter / max(union, 1.0)
    return out
