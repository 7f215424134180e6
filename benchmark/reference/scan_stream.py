"""The plain reference of `cli slam --data`'s scan stream: a KITTI
`velodyne/` directory read in plain numpy, written from the stream's
semantics and sharing no code with the port.

A `.bin` file is float32 rows of x, y, z, reflectance (16 bytes a point,
the KITTI odometry layout). Of the files in numeric order, those at
start, start + skip, ... below end are read; each is cut to its first
`decode_cap` points, its reflectance is scaled by `max_intensity`, and of
the points that share a leaf of `leaf` metres (the leaf index
floor(coordinate / leaf), computed in float32) the first in file order
is kept, in file order. The kept points fill the front of a scan padded
to `max_points` (zeros beyond, `valid` false), cut at `max_points`.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

Scan = Tuple[np.ndarray, np.ndarray, np.ndarray]   # xyz, intensity, valid


def frame_files(directory) -> List[Path]:
    """The `.bin` files of `directory`, in the numeric order of their
    names."""
    return sorted(Path(directory).glob("*.bin"), key=lambda p: int(p.stem))


def first_per_leaf(xyz: np.ndarray, leaf: float) -> np.ndarray:
    """Bool mask of the points kept: in each leaf, the one with the lowest
    index. A stable sort by (i, j, k) puts each leaf's points together in
    file order, so the first of each run is that leaf's first point."""
    ijk = np.floor(xyz / np.float32(leaf)).astype(np.int64)
    order = np.lexsort((ijk[:, 2], ijk[:, 1], ijk[:, 0]))
    s = ijk[order]
    starts = np.ones(len(order), bool)
    starts[1:] = (s[1:] != s[:-1]).any(axis=1)
    keep = np.zeros(len(xyz), bool)
    keep[order[starts]] = True
    return keep


def read_scan(path, max_intensity: float, leaf: float, decode_cap: int,
              max_points: int) -> Scan:
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:decode_cap]
    xyz = pts[:, :3]
    inten = pts[:, 3] * np.float32(max_intensity)
    keep = first_per_leaf(xyz, leaf)
    xyz, inten = xyz[keep][:max_points], inten[keep][:max_points]
    n = len(xyz)
    X = np.zeros((max_points, 3), np.float32)
    I = np.zeros((max_points,), np.float32)
    V = np.zeros((max_points,), bool)
    X[:n], I[:n], V[:n] = xyz, inten, True
    return X, I, V


def read_sequence(directory, start: int, end: int, skip: int,
                  max_intensity: float, leaf: float, decode_cap: int,
                  max_points: int) -> List[Scan]:
    """The padded scans of the files start, start + skip, ... below `end`
    (every file where `end` <= 0)."""
    files = frame_files(directory)
    end = end if end > 0 else len(files)
    return [read_scan(files[i], max_intensity, leaf, decode_cap, max_points)
            for i in range(start, min(end, len(files)), skip)]
