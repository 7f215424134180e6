"""Artifact writers: colored segmentation clouds & per-voxel intensity dumps.

Covers the reference's visualization/debug outputs:
  * saveSegCloud (src/ssc.cpp:469-569): per-frame clouds colored by cluster
    type/state - dynamic red, building 139/90/0, tree 162/205/90, car a
    deterministic per-track color;
  * recordIntensity (src/ssc.cpp:1550-1587): per-voxel intensity mean /
    variance dumps;
  * plotStatic's recolor-by-GT ("remain" map, src/plotStatic.cpp).

Counterpart of dr_using_scv_od_tpu/utils/artifacts.py, in numpy.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..eval.metrics import is_dynamic_label
from . import io_kitti

COLOR_DYNAMIC = (255, 0, 0)
COLOR_BUILDING = (139, 90, 0)
COLOR_TREE = (162, 205, 90)
COLOR_UNKNOWN = (255, 255, 255)


def _track_color(track_id: np.ndarray) -> np.ndarray:
    """Deterministic pseudo-random track colors in [20, 200) (the
    reference uses cv::RNG uniforms, src/ssc.cpp:1267-1270)."""
    t = track_id.astype(np.uint32)
    r = 20 + (t * 2654435761 % 180)
    g = 20 + (t * 2246822519 % 180)
    b = 20 + (t * 3266489917 % 180)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def colored_segmentation(xyz: np.ndarray, point_cluster: np.ndarray,
                         cluster_type: np.ndarray, cluster_state: np.ndarray,
                         cluster_track: np.ndarray) -> np.ndarray:
    """[N, 6] xyzrgb rows for live points (cluster >= 0)."""
    live = point_cluster >= 0
    pc = point_cluster[live]
    typ = cluster_type[pc]
    state = cluster_state[pc]
    tid = cluster_track[pc]
    rgb = np.full((live.sum(), 3), COLOR_UNKNOWN, np.uint8)
    rgb[typ == 0] = COLOR_BUILDING
    rgb[typ == 1] = COLOR_TREE
    car = typ == 2
    rgb[car] = _track_color(np.where(tid[car] >= 0, tid[car],
                                     pc[car] + 7919))
    rgb[state == 1] = COLOR_DYNAMIC
    return np.concatenate([xyz[live], rgb.astype(np.float32)], axis=1)


def write_colored_pcd(path: str | Path, xyzrgb: np.ndarray) -> None:
    """Binary PCD with packed RGB float (PCL convention)."""
    n = len(xyzrgb)
    rgb = xyzrgb[:, 3:6].astype(np.uint32)
    packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    data = np.zeros((n, 4), np.float32)
    data[:, :3] = xyzrgb[:, :3]
    data[:, 3] = packed.view(np.float32)
    with open(path, "wb") as f:
        hdr = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
               "FIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F F\n"
               f"COUNT 1 1 1 1\nWIDTH {n}\nHEIGHT 1\n"
               "VIEWPOINT 0 0 0 1 0 0 0\n"
               f"POINTS {n}\nDATA binary\n")
        f.write(hdr.encode())
        f.write(data.tobytes())


def remain_map(xyz: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Recolor a static map by GT dynamic labels: remaining dynamic points
    red, static grey (src/plotStatic.cpp:15-49)."""
    dyn = is_dynamic_label(labels)
    rgb = np.full((len(xyz), 3), (205, 192, 176), np.float32)
    rgb[dyn] = COLOR_DYNAMIC
    return np.concatenate([xyz, rgb], axis=1)


def record_intensity(path_prefix: str | Path, count: np.ndarray,
                     mean: np.ndarray, var: np.ndarray) -> None:
    """Tab-separated per-occupied-voxel mean/variance dumps
    (recordIntensity, src/ssc.cpp:1550-1587; variance scaled by 1/100 as
    the reference does at :1582)."""
    occ = count > 0
    with open(f"{path_prefix}_av.txt", "w") as f:
        f.write("\t".join(f"{v:.4f}" for v in mean[occ]) + "\t")
    with open(f"{path_prefix}_cov.txt", "w") as f:
        f.write("\t".join(f"{v / 100.0:.4f}" for v in var[occ]) + "\t")
