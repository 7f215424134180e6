"""RI3 intensity fusion of a connected-components labelling: the
counterpart of the Pallas TPU kernel
dr_using_scv_od_tpu/ops/pallas/ri3_kernel.py (`refine_by_intensity_pallas`,
same argument order).

Contract, on any input: a voxel is occupied when count > 0; the edges are
the Chebyshev-1 pairs of occupied voxels plus the pairs at Chebyshev
2..search_c that pass the intensity gate of ops/cluster_labels.py; each
occupied voxel gets the minimum INPUT label `root_grid[v]` of its
component, each empty voxel its own id. On a connected-components fixpoint
(the output of cc_labels) the result equals cluster_labels on the same
occupancy.

Two deliberate differences from the TPU kernel, as for cluster_labels:
means are compared as floats, not as round(mean * 8192) codes
(ri3_kernel.py:220-225), and the fixpoint is exact, with no max_outer cap.
The shell covers every Chebyshev distance 2..search_c, as fused_seg.py and
the XLA models/segmentation.refine_by_intensity do; ri3_kernel.py:130
visits only distance search_c, which agrees with them at the default
search_c = 2 only.

`ri3_labels` dispatches on the device of its input, with no fallback: a
CPU tensor goes to `ri3_labels_reference`, a CUDA tensor to the
hand-written union-find kernel in csrc/ri3_labels.cu (built with nvcc for
sm_90a at first use, ops/cuda_build.py), or the call raises.
`ri3_labels.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cluster_labels, clustering, cuda_build

_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4
             + (ctypes.c_float, ctypes.c_float, ctypes.c_int))


def ri3_labels_reference(root_grid: torch.Tensor, count: torch.Tensor,
                         intensity_mean: torch.Tensor,
                         intensity_var: torch.Tensor,
                         shape3: Tuple[int, int, int], search_c: int,
                         intensity_cov: float, intensity_diff: float,
                         far_range_frac: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: min-label
    propagation seeded with root_grid's labels over the edge list of
    cluster_labels.union_graph_edges."""
    ids, src, dst = cluster_labels.union_graph_edges(
        (count > 0).reshape(shape3), intensity_mean, intensity_var,
        cluster_labels.shell_radius(search_c, True), intensity_cov,
        intensity_diff, far_range_frac)
    return clustering.min_label_components(count.numel(), ids, src, dst,
                                           init=root_grid)


def ri3_labels(root_grid: torch.Tensor, count: torch.Tensor,
               intensity_mean: torch.Tensor, intensity_var: torch.Tensor,
               shape3: Tuple[int, int, int], search_c: int,
               intensity_cov: float, intensity_diff: float,
               far_range_frac: float) -> torch.Tensor:
    """[G] int32 labels + [G] int32 point counts + [G] f32 intensity mean
    and variance -> [G] int32 fused labels (the contract of
    ri3_kernel.refine_by_intensity_pallas at its exact fixpoint)."""
    if root_grid.device.type == "cpu":
        return ri3_labels_reference(
            root_grid, count, intensity_mean, intensity_var, shape3,
            search_c, intensity_cov, intensity_diff, far_range_frac)
    if root_grid.device.type != "cuda":
        raise ValueError(f"no ri3_labels kernel for {root_grid.device}")
    A, R, S = shape3
    G = A * R * S
    if G <= 0:
        raise ValueError(f"shape3 must be a non-empty grid, got {shape3}")
    for name, t, dtype in (("root_grid", root_grid, torch.int32),
                           ("count", count, torch.int32),
                           ("intensity_mean", intensity_mean, torch.float32),
                           ("intensity_var", intensity_var, torch.float32)):
        cuda_build.check_input(name, t, dtype, G, root_grid.device)
    out = torch.empty(G, dtype=torch.int32, device=root_grid.device)
    slot = torch.empty(G, dtype=torch.int32, device=root_grid.device)
    cuda_build.launch(
        "ri3_labels", _ARGTYPES, root_grid.device,
        root_grid.data_ptr(), count.data_ptr(), intensity_mean.data_ptr(),
        intensity_var.data_ptr(), out.data_ptr(), slot.data_ptr(), A, R, S,
        cluster_labels.shell_radius(search_c, True), intensity_cov,
        intensity_diff, int(R * far_range_frac))
    ri3_labels.launches += 1
    return out


ri3_labels.launches = 0
