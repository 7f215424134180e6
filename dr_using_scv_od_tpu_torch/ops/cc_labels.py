"""26-connected components of the curved-voxel grid: the counterpart of the
Pallas TPU kernel dr_using_scv_od_tpu/ops/pallas/cc_kernel.py
(`connected_components_pallas`).

`cc_labels` returns [G] int32 labels, each occupied voxel the minimum flat
id of its component and each empty voxel its own id. It dispatches on the
device of its input, with no fallback:

  * a CPU tensor goes to the plain PyTorch version,
    `ops/clustering.connected_components` (min-label propagation over the
    explicit edge list);
  * a CUDA tensor goes to the hand-written tiled union-find kernel in
    csrc/cc_labels.cu (see its header and csrc/tiled_union_find.cuh for
    the design), with the radius-1 tile plan of ops/tile_plan.py, or the
    call raises.

The kernel is built with nvcc for sm_90a at first use (ops/cuda_build.py).
`cc_labels.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import clustering, cuda_build, tile_plan

_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 9


def cc_labels(occupied3: torch.Tensor) -> torch.Tensor:
    """[A,R,S] bool occupancy -> [G] int32 min-flat-id component labels
    (the contract of cc_kernel.connected_components_pallas at its exact
    fixpoint)."""
    if occupied3.device.type == "cpu":
        return clustering.connected_components(occupied3)
    if occupied3.device.type != "cuda":
        raise ValueError(f"no cc_labels kernel for {occupied3.device}")
    if occupied3.dim() != 3 or occupied3.numel() == 0:
        raise ValueError(f"occupied3 must be a non-empty [A,R,S] grid, got "
                         f"{tuple(occupied3.shape)}")
    cuda_build.check_input("occupied3", occupied3, torch.bool,
                           occupied3.numel(), occupied3.device)
    A, R, S = occupied3.shape
    plan = tile_plan.plan((A, R, S), 1)
    out = torch.empty(A * R * S, dtype=torch.int32, device=occupied3.device)
    flag = torch.empty(plan.n_tiles, dtype=torch.int32,
                       device=occupied3.device)
    cuda_build.launch("cc_labels", _ARGTYPES, occupied3.device,
                      occupied3.data_ptr(), out.data_ptr(), flag.data_ptr(),
                      A, R, S, *plan.kernel_args)
    cc_labels.launches += 1
    return out


cc_labels.launches = 0
