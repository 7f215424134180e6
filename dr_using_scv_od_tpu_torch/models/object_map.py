"""Multi-frame object-map initialization (counterpart of
dr_using_scv_od_tpu/models/object_map.py; reference SSC::intialization,
src/ssc.cpp:1148-1248, designed but never invoked there): pick the frame
with the fewest clusters as the base, project every other frame's clusters
into the base curved-voxel grid through the relative poses, and fuse base
clusters that one foreign cluster co-occupies with >= `occupancy`
voxel-overlap ratio.

The JAX package's `lax.scan` over frames is a Python loop; each frame's
(cluster, voxel) keys are deduplicated after a stable sort and counted into
one integer [C+1, C+1] contingency matrix with `bincount`. Conflicting
fusions resolve to the minimum base row, and the fusion map is closed over
two folds (`mapping[mapping]`, twice), exactly as the JAX function does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PipelineConfig
from ..ops import geometry, quantize
from ..types import ClusterTable, take

_INT_MAX = torch.iinfo(torch.int32).max


class ObjectMapResult(NamedTuple):
    base_idx: torch.Tensor      # scalar int32 - chosen base frame
    label_grid: torch.Tensor    # [G] fused base label grid
    table: ClusterTable         # fused base cluster table
    n_fused: torch.Tensor       # scalar int32 - clusters removed by fusion


def _label_voxels(grid: torch.Tensor, C: int) -> torch.Tensor:
    """[C] int32 voxels per label of a label grid (-1 = empty)."""
    return torch.bincount(torch.where(grid >= 0, grid, C).long(),
                          minlength=C + 1)[:C].to(torch.int32)


def initialize(xyz: torch.Tensor, point_voxel: torch.Tensor,
               point_valid: torch.Tensor, label_grids: torch.Tensor,
               tables: ClusterTable, poses: torch.Tensor,
               cfg: PipelineConfig) -> ObjectMapResult:
    """Fuse an init window ([F, ...] stacked per-frame outputs) into an
    object-level base map."""
    F = xyz.shape[0]
    C = cfg.shapes.max_clusters
    G = cfg.grid.bin_num
    device = xyz.device
    rows = torch.arange(C, dtype=torch.int64, device=device)

    n_clusters = tables.valid.sum(dim=1)
    # reference picks min cluster count, ties -> later frame (<=, :1154)
    base = F - 1 - int(torch.argmin(torch.flip(n_clusters, dims=(0,))))

    base_grid = label_grids[base]
    base_pose_inv = geometry.inverse_se3(poses[base])
    n_fused = torch.zeros((), dtype=torch.int32, device=device)
    for i in range(F):
        if i == base:
            # the base frame hits nothing: its mapping is the identity
            continue
        T_bi = base_pose_inv @ poses[i]
        pv = point_voxel[i]
        pvalid = point_valid[i] & (pv >= 0)
        pc = torch.where(pvalid, label_grids[i][torch.clamp(pv, 0, G - 1)
                                                .long()], -1)
        warped = geometry.transform_points(T_bi, xyz[i])
        _, vflat, in_fov = quantize.quantize(warped, pvalid & (pc >= 0),
                                             cfg.grid)
        blab = torch.where(in_fov, base_grid[torch.clamp(vflat, 0, G - 1)
                                             .long()], -1)
        hit = in_fov & (blab >= 0)

        key = torch.where(hit, pc.long() * G + vflat, _INT_MAX)
        skey, order = torch.sort(key, stable=True)
        uniq = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                          skey[1:] != skey[:-1]]) & (skey != _INT_MAX)
        cell = pc[order].long() * (C + 1) + blab[order].long()
        cont = torch.bincount(cell[uniq], minlength=(C + 1) ** 2)
        cont = cont.reshape(C + 1, C + 1)[:C, :C].to(torch.int32)

        ratio = cont.to(torch.float32) / torch.clamp_min(
            _label_voxels(base_grid, C), 1)[None, :].to(torch.float32)
        qual = (cont > 0) & (ratio >= cfg.track.occupancy)
        fuse_row = (cont > 0).sum(dim=1) > 1          # remap_name.size() > 1
        qual = qual & fuse_row[:, None]
        # fuse all base labels claimed by one foreign cluster into the
        # minimum claimed base label
        claimed = qual.any(dim=0)
        row_min = torch.where(qual, rows[None, :], _INT_MAX).amin(dim=1)
        fuse_to = torch.where(qual, row_min[:, None], _INT_MAX).amin(dim=0)
        do = (fuse_to != _INT_MAX) & claimed
        mapping = torch.where(do, fuse_to, rows)
        # transitive closure (short chains): two folds
        mapping = mapping[mapping]
        mapping = mapping[mapping]
        n_fused = n_fused + (mapping != rows).sum(dtype=torch.int32)
        base_grid = torch.where(
            base_grid >= 0,
            mapping[torch.clamp(base_grid, 0, C - 1).long()].to(torch.int32),
            base_grid)

    # rebuild base table from the fused grid
    base_table = take(tables, base)
    nvox = _label_voxels(base_grid, C)
    table = base_table.replace(valid=base_table.valid & (nvox > 0),
                               n_voxels=nvox)
    return ObjectMapResult(
        base_idx=torch.tensor(base, dtype=torch.int32, device=device),
        label_grid=base_grid, table=table, n_fused=n_fused)
