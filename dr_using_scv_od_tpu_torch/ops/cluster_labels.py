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

The kernel is built with nvcc for sm_90a at first use (ops/cuda_build.py).
`cluster_labels.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import clustering, cuda_build

_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
             + (ctypes.c_float, ctypes.c_float, ctypes.c_int))


def shell_radius(search_c: int, enable_shell: bool) -> int:
    """Neighbourhood radius: search_c with the shell on (and search_c >= 2,
    as in fused_seg.py:272), else 1 (plain CC, the "-RI3" ablation)."""
    return search_c if enable_shell and search_c >= 2 else 1


def union_graph_edges(occupied3: torch.Tensor,
                      intensity_mean: torch.Tensor,
                      intensity_var: torch.Tensor, radius: int,
                      intensity_cov: float, intensity_diff: float,
                      far_range_frac: float):
    """The union graph as an edge list: (ids [M] ascending flat ids of the
    occupied voxels, src [E], dst [E] flat ids). Every forward neighbour
    pair of occupied voxels at Chebyshev 1, and at Chebyshev 2..radius the
    pairs that pass the intensity gate (csrc/union_find.cuh)."""
    A, R, S = occupied3.shape
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
    return ids, ids[:, None].expand_as(nbr)[ok], nbr[ok]


def cluster_labels_reference(occupied3: torch.Tensor,
                             intensity_mean: torch.Tensor,
                             intensity_var: torch.Tensor,
                             search_c: int, intensity_cov: float,
                             intensity_diff: float, far_range_frac: float,
                             enable_shell: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: min-label
    propagation with pointer jumping over the edge list of
    `union_graph_edges`, until nothing changes."""
    ids, src, dst = union_graph_edges(
        occupied3, intensity_mean, intensity_var,
        shell_radius(search_c, enable_shell), intensity_cov,
        intensity_diff, far_range_frac)
    return clustering.min_label_components(occupied3.numel(), ids, src, dst)


def _check_inputs(occupied3, intensity_mean, intensity_var):
    if occupied3.dim() != 3 or occupied3.numel() == 0:
        raise ValueError(f"occupied3 must be a non-empty [A,R,S] grid, got "
                         f"{tuple(occupied3.shape)}")
    G = occupied3.numel()
    for name, t, dtype in (("occupied3", occupied3, torch.bool),
                           ("intensity_mean", intensity_mean, torch.float32),
                           ("intensity_var", intensity_var, torch.float32)):
        cuda_build.check_input(name, t, dtype, G, occupied3.device)


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
    cuda_build.launch(
        "cluster_labels", _ARGTYPES, occupied3.device,
        occupied3.data_ptr(), intensity_mean.data_ptr(),
        intensity_var.data_ptr(), out.data_ptr(), A, R, S,
        shell_radius(search_c, enable_shell), intensity_cov,
        intensity_diff, int(R * far_range_frac))
    cluster_labels.launches += 1
    return out


cluster_labels.launches = 0
