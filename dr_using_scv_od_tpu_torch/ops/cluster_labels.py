"""Fused CVC + RI3 cluster labels: the kernel of the segmentation stage.

`cluster_labels` computes the connected components of the union graph of
dr_using_scv_od_tpu/ops/pallas/fused_seg.py (cheb-1 edges between occupied
voxels, plus intensity-gated edges at cheb 2..search_c when the shell is
on) and returns [G] int32 min-flat-id labels, empty voxels keeping their
own id. It dispatches on the device of its input, with no fallback:

  * a CPU tensor goes to `cluster_labels_reference`, the plain PyTorch
    version: min-label propagation over the explicit edge list;
  * a CUDA tensor goes to the hand-written union-find kernel in
    csrc/cluster_labels.cu (see its header for the design), or the call
    raises.

The kernel is built with nvcc for sm_90a into `build/` beside this package
at first use, keyed by a hash of its source and flags, and loaded with
ctypes. `cluster_labels.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import clustering

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "cluster_labels.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _shell_radius(search_c: int, enable_shell: bool) -> int:
    """Neighbourhood radius: search_c with the shell on (and search_c >= 2,
    as in fused_seg.py:272), else 1 (plain CC, the "-RI3" ablation)."""
    return search_c if enable_shell and search_c >= 2 else 1


def cluster_labels_reference(occupied3: torch.Tensor,
                             intensity_mean: torch.Tensor,
                             intensity_var: torch.Tensor,
                             search_c: int, intensity_cov: float,
                             intensity_diff: float, far_range_frac: float,
                             enable_shell: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: enumerate the
    forward neighbour pairs of occupied voxels, keep the cheb-1 pairs and
    the shell pairs that pass the intensity gate, and run min-label
    propagation with pointer jumping until nothing changes."""
    A, R, S = occupied3.shape
    radius = _shell_radius(search_c, enable_shell)
    offsets = clustering.forward_offsets(radius)
    ids, nbr, ok = clustering.occupied_pairs(occupied3, offsets)
    if radius > 1:
        far_bin = int(R * far_range_frac)
        shell = torch.tensor([max(map(abs, d)) >= 2 for d in offsets],
                             device=ids.device)
        qual = intensity_var <= intensity_cov
        r_v = ((ids // S) % R)[:, None]
        r_n = (nbr // S) % R
        gate = ((qual[nbr] & (r_v <= far_bin))
                | (qual[ids][:, None] & (r_n <= far_bin)))
        close = (intensity_mean[ids][:, None] - intensity_mean[nbr]
                 ).abs() <= intensity_diff
        ok = ok & (~shell | (gate & close))
    src = ids[:, None].expand_as(nbr)[ok]
    return clustering.min_label_components(A * R * S, ids, src, nbr[ok])


def build_library() -> Path:
    """Compile csrc/cluster_labels.cu into BUILD_DIR (once per source and
    flag set) and return the shared library's path."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libcluster_labels_{key}.so"
    if lib.exists():
        return lib
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.cluster_labels_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check_inputs(occupied3, intensity_mean, intensity_var):
    if occupied3.dim() != 3 or occupied3.numel() == 0:
        raise ValueError(f"occupied3 must be a non-empty [A,R,S] grid, got "
                         f"{tuple(occupied3.shape)}")
    G = occupied3.numel()
    for name, t, dtype in (("occupied3", occupied3, torch.bool),
                           ("intensity_mean", intensity_mean, torch.float32),
                           ("intensity_var", intensity_var, torch.float32)):
        if t.device != occupied3.device:
            raise ValueError(f"{name} is on {t.device}, "
                             f"occupied3 on {occupied3.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.numel() != G:
            raise ValueError(f"{name} has {t.numel()} elements, expected {G}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def cluster_labels(occupied3: torch.Tensor, intensity_mean: torch.Tensor,
                   intensity_var: torch.Tensor, search_c: int,
                   intensity_cov: float, intensity_diff: float,
                   far_range_frac: float,
                   enable_shell: bool = True) -> torch.Tensor:
    """[A,R,S] bool occupancy + [G] f32 intensity mean and variance ->
    [G] int32 min-flat-id labels of the union graph (the contract of
    fused_seg.cluster_labels_pallas at its exact fixpoint)."""
    if occupied3.device.type == "cpu":
        return cluster_labels_reference(
            occupied3, intensity_mean, intensity_var, search_c,
            intensity_cov, intensity_diff, far_range_frac, enable_shell)
    if occupied3.device.type != "cuda":
        raise ValueError(f"no cluster_labels kernel for {occupied3.device}")
    _check_inputs(occupied3, intensity_mean, intensity_var)
    A, R, S = occupied3.shape
    out = torch.empty(A * R * S, dtype=torch.int32, device=occupied3.device)
    with torch.cuda.device(occupied3.device):
        stream = torch.cuda.current_stream(occupied3.device).cuda_stream
        err = _library().cluster_labels_launch(
            occupied3.data_ptr(), intensity_mean.data_ptr(),
            intensity_var.data_ptr(), out.data_ptr(), A, R, S,
            _shell_radius(search_c, enable_shell), intensity_cov,
            intensity_diff, int(R * far_range_frac), stream)
    if err != 0:
        raise RuntimeError(f"cluster_labels kernel launch failed: "
                           f"CUDA error {err}")
    cluster_labels.launches += 1
    return out


cluster_labels.launches = 0
