"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc for
sm_90a into its own shared library under `build/` beside this package, at
first use, and loaded with ctypes. A library is keyed by a hash of its
source, every header in `csrc/` (the sources share `union_find.cuh`) and
the nvcc flags, so an edit to any of them builds anew. `launch` calls a
kernel's C entry on the current stream of the tensors' device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` is built, under a key that hashes the source,
    every `csrc/*.cuh` header and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_libraries(*names: str) -> Dict[str, Path]:
    """Compile the named `csrc/*.cu` files that are not built yet, one nvcc
    process each, all started together; return each library's path."""
    libs = {name: library_path(name) for name in names}
    todo = {name: lib for name, lib in libs.items() if not lib.exists()}
    if not todo:
        return libs
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{err}")
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, building it if needed."""
    return ctypes.CDLL(str(build_libraries(name)[name]))


@functools.cache
def _entry(name: str, argtypes: tuple):
    fn = getattr(load(name), f"{name}_launch")
    fn.argtypes = [*argtypes, ctypes.c_void_p]       # the stream comes last
    fn.restype = ctypes.c_int
    return fn


def check_input(name: str, t: torch.Tensor, dtype: torch.dtype, numel: int,
                device: torch.device) -> None:
    """Raise unless `t` is what a kernel takes: a contiguous `dtype` tensor
    of `numel` elements on `device`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected {numel}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(name: str, argtypes: tuple, device: torch.device, *args) -> None:
    """Call the C entry `<name>_launch(*args, stream)` of `csrc/<name>.cu`
    on `device` and its current stream, and raise if it returns a CUDA
    error. `argtypes` are the ctypes of `args` (c_void_p for a pointer)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _entry(name, argtypes)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
