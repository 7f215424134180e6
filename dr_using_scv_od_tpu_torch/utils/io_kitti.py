"""Dataset IO: SemanticKITTI scans/labels/poses and binary PCD artifacts.

Mirrors the reference's loaders:
  * `.bin` + `.label` decode with unlabeled filtering, intensity scaling
    and voxel downsampling (SSC::getCloud, src/ssc.cpp:997-1146);
  * `poses.txt` camera poses mapped into the velodyne frame with the
    Tr calibration: velo_T = Tr^-1 * cam_T * Tr (SSC::getPose,
    src/ssc.cpp:961-991) - note we index poses by the ORIGINAL frame id
    (the reference's `pose_vec[i-start]` ignores `skip`, a bug we fix;
    SURVEY.md section 7.3);
  * numeric-stem file ordering (fileSort, src/ssc.cpp:12-22).

Decoding uses the native C++ codec (native/io_native.cpp) via ctypes when
built, with a numpy fallback - build with `make -C native`.

A copy of dr_using_scv_od_tpu/utils/io_kitti.py (numpy only; the port
imports nothing of the JAX package), held equal to it by
tests/test_torch_io.py.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_NATIVE: Optional[ctypes.CDLL] = None


def _native() -> Optional[ctypes.CDLL]:
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    so = Path(__file__).resolve().parents[2] / "native" / "libio_native.so"
    if so.exists():
        lib = ctypes.CDLL(str(so))
        lib.kitti_bin_num_points.restype = ctypes.c_int64
        lib.kitti_bin_num_points.argtypes = [ctypes.c_char_p]
        lib.kitti_bin_read.restype = ctypes.c_int
        lib.kitti_bin_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_int64]
        lib.kitti_label_num_points.restype = ctypes.c_int64
        lib.kitti_label_num_points.argtypes = [ctypes.c_char_p]
        lib.kitti_label_read.restype = ctypes.c_int
        lib.kitti_label_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                         ctypes.c_int64]
        lib.pcd_write_xyzi.restype = ctypes.c_int
        lib.pcd_write_xyzi.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_int64]
        lib.pcd_num_points.restype = ctypes.c_int64
        lib.pcd_num_points.argtypes = [ctypes.c_char_p]
        lib.pcd_read_xyzi.restype = ctypes.c_int
        lib.pcd_read_xyzi.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                      ctypes.c_int64]
        _NATIVE = lib
    return _NATIVE


def read_bin(path: str | Path) -> np.ndarray:
    """KITTI velodyne scan -> [N, 4] float32 (x, y, z, intensity)."""
    lib = _native()
    path = str(path)
    if lib is not None:
        n = lib.kitti_bin_num_points(path.encode())
        if n < 0:
            raise FileNotFoundError(path)
        out = np.empty((n, 4), np.float32)
        rc = lib.kitti_bin_read(path.encode(), out.ctypes.data, n)
        if rc != 0:
            raise IOError(f"kitti_bin_read({path}) rc={rc}")
        return out
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_label(path: str | Path) -> np.ndarray:
    """SemanticKITTI label file -> [N] uint32."""
    lib = _native()
    path = str(path)
    if lib is not None:
        n = lib.kitti_label_num_points(path.encode())
        if n < 0:
            raise FileNotFoundError(path)
        out = np.empty((n,), np.uint32)
        rc = lib.kitti_label_read(path.encode(), out.ctypes.data, n)
        if rc != 0:
            raise IOError(f"kitti_label_read({path}) rc={rc}")
        return out
    return np.fromfile(path, dtype=np.uint32)


def write_pcd_xyzi(path: str | Path, xyzi: np.ndarray) -> None:
    xyzi = np.ascontiguousarray(xyzi, np.float32)
    lib = _native()
    if lib is not None:
        rc = lib.pcd_write_xyzi(str(path).encode(), xyzi.ctypes.data,
                                len(xyzi))
        if rc != 0:
            raise IOError(f"pcd_write_xyzi({path}) rc={rc}")
        return
    with open(path, "wb") as f:
        hdr = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
               "FIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\n"
               f"COUNT 1 1 1 1\nWIDTH {len(xyzi)}\nHEIGHT 1\n"
               "VIEWPOINT 0 0 0 1 0 0 0\n"
               f"POINTS {len(xyzi)}\nDATA binary\n")
        f.write(hdr.encode())
        f.write(xyzi.tobytes())


def read_pcd_xyzi(path: str | Path) -> np.ndarray:
    lib = _native()
    path = str(path)
    if lib is not None:
        n = lib.pcd_num_points(path.encode())
        if n < 0:
            raise FileNotFoundError(path)
        out = np.empty((n, 4), np.float32)
        rc = lib.pcd_read_xyzi(path.encode(), out.ctypes.data, n)
        if rc == 0:
            return out
    # python fallback: parse header, assume binary float32 fields
    with open(path, "rb") as f:
        fields, n = [], 0
        while True:
            line = f.readline().decode(errors="replace")
            if line.startswith("FIELDS"):
                fields = line.split()[1:]
            elif line.startswith("POINTS"):
                n = int(line.split()[1])
            elif line.startswith("DATA"):
                assert "binary" in line, "ascii PCD not supported"
                break
        raw = np.frombuffer(f.read(n * 4 * len(fields)),
                            np.float32).reshape(n, len(fields))
    out = np.zeros((n, 4), np.float32)
    out[:, :min(4, raw.shape[1])] = raw[:, :4]
    return out


def sorted_frame_files(directory: str | Path, suffix: str) -> List[Path]:
    """Numeric-stem ordering (fileSort, src/ssc.cpp:12-22); non-numeric
    stems (e.g. a poses.pcd in the scan dir) are skipped."""
    files = [p for p in Path(directory).iterdir()
             if p.suffix == suffix and p.stem.lstrip("-").isdigit()]
    return sorted(files, key=lambda p: int(p.stem))


def load_poses(pose_path: str | Path, tr: np.ndarray,
               start: int, end: int, skip: int) -> np.ndarray:
    """KITTI poses.txt -> [F, 4, 4] velodyne-frame world poses for frames
    start, start+skip, ... < end (src/ssc.cpp:943-991)."""
    raw = np.loadtxt(pose_path, dtype=np.float64).reshape(-1, 12)
    tr = np.asarray(tr, np.float64).reshape(4, 4)
    tr_inv = np.linalg.inv(tr)
    out = []
    for i in range(start, end, skip):
        cam = np.eye(4)
        cam[:3, :] = raw[i].reshape(3, 4)
        out.append((tr_inv @ cam @ tr).astype(np.float32))
    return np.stack(out)


def load_scan(bin_path: str | Path, label_path: Optional[str | Path],
              max_intensity: float = 255.0,
              drop_unlabeled: bool = True
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One scan with reference load semantics (src/ssc.cpp:1063-1103):
    returns (xyz [N,3] f32, intensity [N] f32 scaled, labels [N] uint32).
    Unlabeled points (semantic 0/1) are dropped when labels exist."""
    pts = read_bin(bin_path)
    if label_path is not None:
        labels = read_label(label_path)
        assert len(labels) == len(pts), (bin_path, label_path)
        if drop_unlabeled:
            sem = labels & 0xFFFF
            keep = (sem != 0) & (sem != 1)
            pts, labels = pts[keep], labels[keep]
    else:
        labels = np.zeros(len(pts), np.uint32)
    xyz = pts[:, :3]
    inten = pts[:, 3] * max_intensity
    return xyz, inten, labels


def load_window(data_path: str | Path, label_path: Optional[str | Path],
                pose_path: str | Path, tr: np.ndarray,
                start: int, end: int, skip: int, max_points: int,
                max_intensity: float = 255.0, downsample_leaf: float = 0.08):
    """A full padded window, reference load chain (getPose + getCloud).

    Voxel downsampling at `downsample_leaf` (reference uses 0.08 m for the
    pipeline cloud, src/ssc.cpp:1110) runs on host via numpy here.
    Returns dict of stacked arrays like utils.synthetic.render_window.
    """
    bins = sorted_frame_files(data_path, ".bin")
    labs = sorted_frame_files(label_path, ".label") if label_path else None
    poses = load_poses(pose_path, tr, start, end, skip)
    xs, ins, ls, vs = [], [], [], []
    for k, i in enumerate(range(start, end, skip)):
        xyz, inten, labels = load_scan(
            bins[i], labs[i] if labs else None, max_intensity)
        if downsample_leaf > 0:
            keep = _voxel_downsample_np(xyz, downsample_leaf)
            xyz, inten, labels = xyz[keep], inten[keep], labels[keep]
        n = min(len(xyz), max_points)
        X = np.zeros((max_points, 3), np.float32)
        I = np.zeros((max_points,), np.float32)
        L = np.zeros((max_points,), np.int64)
        V = np.zeros((max_points,), bool)
        X[:n], I[:n], L[:n], V[:n] = xyz[:n], inten[:n], labels[:n], True
        xs.append(X); ins.append(I); ls.append(L); vs.append(V)
    return {"xyz": np.stack(xs), "intensity": np.stack(ins),
            "label": np.stack(ls), "valid": np.stack(vs), "poses": poses}


def _voxel_downsample_np(xyz: np.ndarray, leaf: float) -> np.ndarray:
    """First-point-per-leaf downsample on the host."""
    ijk = np.floor(xyz / leaf).astype(np.int64)
    _, idx = np.unique(ijk, axis=0, return_index=True)
    keep = np.zeros(len(xyz), bool)
    keep[idx] = True
    return keep
