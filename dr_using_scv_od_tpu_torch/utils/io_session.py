"""PCD-session dataset mode + scan accumulation utilities.

Covers the reference's `is_pcd` path (config/parkinglot.yaml: scans are a
directory of PCDs, poses a PCD of LIO-SAM-style XYZIRPYT records -
SSC::getPose/getCloud pcd branches, src/ssc.cpp:914-925, 998-1019) and the
`ufo_scan` dataset-prep tool (src/makeScan.cpp:108-251: accumulate 3
consecutive sparse scans into the middle frame via poses).

Counterpart of dr_using_scv_od_tpu/utils/io_session.py: host-side numpy
around the port's `ops/geometry`, which runs on the device the caller names
(`device` is a required keyword wherever a function computes).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from ..ops import geometry
from . import io_kitti


def read_pcd_fields(path: str | Path) -> Tuple[np.ndarray, List[str]]:
    """Generic binary PCD reader: returns ([N, n_fields] f32, field names).
    Assumes all fields are 4-byte (float32 or int32-as-float reinterp),
    which covers every artifact the reference writes."""
    with open(path, "rb") as f:
        fields: List[str] = []
        sizes: List[int] = []
        n = 0
        while True:
            line = f.readline().decode(errors="replace")
            if not line:
                raise IOError(f"no DATA header in {path}")
            if line.startswith("FIELDS"):
                fields = line.split()[1:]
            elif line.startswith("SIZE"):
                sizes = [int(s) for s in line.split()[1:]]
            elif line.startswith("POINTS"):
                n = int(line.split()[1])
            elif line.startswith("DATA"):
                if "binary" not in line:
                    raise IOError("ascii PCD not supported")
                break
        stride = sum(sizes) if sizes else 4 * len(fields)
        raw = np.frombuffer(f.read(n * stride), np.uint8).reshape(n, stride)
        cols = []
        off = 0
        for sz in (sizes or [4] * len(fields)):
            cols.append(raw[:, off:off + 4].copy().view(np.float32)[:, 0])
            off += sz
        return np.stack(cols, axis=1), fields


def load_pose_cloud(path: str | Path, *,
                    device: torch.device | str) -> np.ndarray:
    """Pose PCD (XYZIRPYT, include/utility.h:77-93) -> [F, 4, 4]; the Euler
    conversion runs on `device`."""
    data, fields = read_pcd_fields(path)
    idx = {f: i for i, f in enumerate(fields)}
    need = ["x", "y", "z", "roll", "pitch", "yaw"]
    for k in need:
        if k not in idx:
            raise IOError(f"pose pcd missing field {k} (has {fields})")
    xyzrpy = np.stack([data[:, idx[k]] for k in need], axis=1)
    return geometry.pose_to_matrix(
        torch.as_tensor(xyzrpy, device=device)).cpu().numpy()


def load_session_window(data_dir: str | Path, pose_pcd: str | Path,
                        start: int, end: int, skip: int, max_points: int,
                        *, device: torch.device | str):
    """The reference's is_pcd load chain (src/ssc.cpp:914-925, 998-1019);
    `device` is where the poses are converted (load_pose_cloud)."""
    files = io_kitti.sorted_frame_files(data_dir, ".pcd")
    poses = load_pose_cloud(pose_pcd, device=device)
    xs, ins, vs, ps = [], [], [], []
    for i in range(start, end, skip):
        xyzi = io_kitti.read_pcd_xyzi(files[i])
        n = min(len(xyzi), max_points)
        X = np.zeros((max_points, 3), np.float32)
        I = np.zeros((max_points,), np.float32)
        V = np.zeros((max_points,), bool)
        X[:n], I[:n], V[:n] = xyzi[:n, :3], xyzi[:n, 3], True
        xs.append(X); ins.append(I); vs.append(V)
        ps.append(poses[i])
    F = len(xs)
    return {"xyz": np.stack(xs), "intensity": np.stack(ins),
            "label": np.zeros((F, max_points), np.int64),
            "valid": np.stack(vs), "poses": np.stack(ps).astype(np.float32)}


def accumulate_scans(scans: List[np.ndarray], poses: List[np.ndarray],
                     center: int, *,
                     device: torch.device | str) -> np.ndarray:
    """Merge neighbouring scans into the `center` frame via relative poses
    (the ufo_scan densification, src/makeScan.cpp:150-223). scans are
    [N_i, 4] xyzi in their own sensor frames; returns merged [M, 4]. The
    points are transformed on `device`."""
    Tc_inv = np.linalg.inv(poses[center])
    out = []
    for s, T in zip(scans, poses):
        rel = (Tc_inv @ T).astype(np.float32)
        xyz = geometry.transform_points(
            torch.as_tensor(rel, device=device),
            torch.as_tensor(np.ascontiguousarray(s[:, :3], np.float32),
                            device=device)).cpu().numpy()
        out.append(np.concatenate([xyz, s[:, 3:4]], axis=1))
    return np.concatenate(out)
