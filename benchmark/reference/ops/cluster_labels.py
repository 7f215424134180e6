"""Kernel 1's contract in plain PyTorch: the connected components of the
fused CVC + RI3 union graph (cheb-1 edges between occupied voxels, plus
intensity-gated edges at cheb 2..search_c when the shell is on), as [G]
int32 min-flat-id labels, empty voxels keeping their own id.

Frozen copy of the port's ops/cluster_labels.py without the CUDA path:
`cluster_labels` runs `cluster_labels_reference` on every device.
"""

from __future__ import annotations

import torch

from . import clustering


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


def cluster_labels(occupied3: torch.Tensor, intensity_mean: torch.Tensor,
                   intensity_var: torch.Tensor, search_c: int,
                   intensity_cov: float, intensity_diff: float,
                   far_range_frac: float,
                   enable_shell: bool = True) -> torch.Tensor:
    """[A,R,S] bool occupancy + [G] f32 intensity mean and variance ->
    [G] int32 min-flat-id labels of the union graph, on any device."""
    return cluster_labels_reference(
        occupied3, intensity_mean, intensity_var, search_c, intensity_cov,
        intensity_diff, far_range_frac, enable_shell)
