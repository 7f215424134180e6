"""SCV-OD tracking and dynamic detection (counterpart of
dr_using_scv_od_tpu/models/tracking.py:62-347; reference SSC::tracking,
src/ssc.cpp:1250-1426).

A previous frame's car cluster is DYNAMIC iff its curved-voxel footprint,
re-projected into the next frame's grid with the relative pose, fails to
re-occupy (>= `occupancy`) a car cluster there. Per pair: transform the
car points, re-quantize them, deduplicate (cluster, voxel) pairs with one
sort, build the contingency matrix cont[c, l] = distinct next-voxels of
next cluster l hit by prev cluster c, evaluate the verdict lattice over all
clusters, and apply the split/merge edits of the next frame. All verdicts
read the pre-mutation state, and conflicting edits resolve to the minimum
prev-cluster row, as in the JAX package.

The window is a Python loop over pairs (the JAX package's `lax.scan`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PipelineConfig
from ..types import (STATE_DYNAMIC, STATE_STATIC, TYPE_CAR, ClusterTable,
                     stack, take)
from ..ops import geometry, quantize, segment_ops

_INT_MAX = torch.iinfo(torch.int32).max
_KEY_PAD = torch.iinfo(torch.int64).max


class TrackingResult(NamedTuple):
    tables: ClusterTable          # [F, C] finalized
    label_grids: torch.Tensor     # [F, G] mutated label grids
    point_cluster: torch.Tensor   # [F, N] final per-point cluster ids
    n_dynamic: torch.Tensor       # [F] int32 dynamic verdicts per pair
    new_row_overflow: torch.Tensor      # scalar int32: out of cluster rows
    track_point_overflow: torch.Tensor  # scalar int32: past max_track_points
    counter: torch.Tensor         # scalar int32 next unassigned track id


def _scatter(size, fill, index, src, reduce):
    """A [size] int32 table `fill`ed, then reduced by `src` at `index`."""
    out = torch.full((size,), fill, dtype=torch.int32, device=src.device)
    return out.scatter_reduce(0, index.long(), src.to(torch.int32), reduce)


def _pair_step(prev_table: ClusterTable, prev_grid: torch.Tensor,
               next_table: ClusterTable, next_grid: torch.Tensor,
               prev_xyz: torch.Tensor, prev_point_voxel: torch.Tensor,
               prev_valid: torch.Tensor, T_np: torch.Tensor,
               counter: torch.Tensor, cfg: PipelineConfig,
               occupancy: float | None = None):
    """One tracking pair. Returns (prev_table_final, next_table_mut,
    next_grid_mut, counter, n_dynamic, row_overflow, track_overflow,
    prev point clusters). `occupancy` overrides cfg.track.occupancy."""
    C = cfg.shapes.max_clusters
    G = cfg.grid.bin_num
    device = prev_xyz.device
    c_iota = torch.arange(C, dtype=torch.int32, device=device)

    # ---- fresh track ids for untracked prev car clusters (ssc.cpp:1266-71)
    is_car_row = prev_table.valid & (prev_table.type == TYPE_CAR)
    needs_tid = is_car_row & (prev_table.track_id == -1)
    tid_rank = torch.cumsum(needs_tid.to(torch.int32), 0,
                            dtype=torch.int32) - 1
    track_id = torch.where(needs_tid, counter + tid_rank,
                           prev_table.track_id)
    counter = counter + needs_tid.sum().to(torch.int32)
    prev_table = prev_table.replace(track_id=track_id)

    # ---- prev points' clusters and car flags
    pv_safe = torch.clamp(prev_point_voxel, 0, G - 1).long()
    pc = torch.where(prev_valid & (prev_point_voxel >= 0),
                     prev_grid[pv_safe], -1)
    pt_car = (pc >= 0) & is_car_row[torch.clamp(pc, 0, C - 1).long()]

    # ---- compact car points into the K-slot budget, uniformly strided
    # over scan order when the budget binds
    K = cfg.shapes.max_track_points
    N = prev_xyz.shape[0]
    rank = torch.cumsum(pt_car.to(torch.int32), 0, dtype=torch.int32) - 1
    total = pt_car.sum().to(torch.int32)
    stride = torch.clamp_min((total + K - 1) // K, 1)
    sel = pt_car & (rank % stride == 0)
    csel = torch.cumsum(sel.to(torch.int32), 0, dtype=torch.int32)
    k_iota = torch.arange(K, dtype=torch.int32, device=device)
    idx = torch.searchsorted(csel, k_iota + 1, side="left")
    ccar = k_iota < torch.clamp(csel[-1], max=K)
    idx_safe = torch.clamp(idx, 0, N - 1)
    cxyz = torch.where(ccar[:, None], prev_xyz[idx_safe], 0.0)
    cpc = torch.where(ccar, pc[idx_safe], -1)
    track_overflow = total - ccar.sum().to(torch.int32)

    warped = geometry.transform_points(T_np, cxyz)
    _, vflat, in_fov = quantize.quantize(warped, ccar, cfg.grid)
    v_safe = torch.clamp(vflat, 0, G - 1)
    nlab = torch.where(in_fov, next_grid[v_safe.long()], -1)
    hit = in_fov & (nlab >= 0)

    # clusters with no budgeted point, or sampled too sparsely to keep
    # their voxel coverage, stay unjudged
    has_budgeted_pt = _scatter(C, 0, torch.clamp(cpc, 0, C - 1),
                               ccar & (cpc >= 0), "amax") > 0
    sufficient = (stride <= 1) | (
        prev_table.n_points
        >= stride * torch.clamp_min(prev_table.n_voxels, 1))

    # ---- dedup (prev cluster, voxel) pairs: one sort (ssc.cpp:1320-1321)
    key = torch.where(hit, cpc.long() * G + vflat.long(), _KEY_PAD)
    skey, order = torch.sort(key)
    uniq = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                      skey[1:] != skey[:-1]]) & (skey != _KEY_PAD)
    u_c = torch.where(uniq, cpc[order], C)
    u_v = torch.where(uniq, v_safe[order], 0)
    u_l = torch.where(uniq, nlab[order], C)

    # ---- contingency cont[c, l] = #distinct voxels (ssc.cpp:1304-1336)
    cont = torch.bincount((u_c * (C + 1) + u_l).long(),
                          minlength=(C + 1) ** 2)
    cont = cont.reshape(C + 1, C + 1)[:C, :C].to(torch.int32)

    nvox_next = torch.clamp_min(next_table.n_voxels, 1).to(torch.float32)
    ratio = cont.to(torch.float32) / nvox_next[None, :]
    hit_any = cont > 0
    n_labels = hit_any.sum(1)
    lstar = torch.argmax(cont, dim=1)      # the single label if n == 1
    ratio1 = ratio.gather(1, lstar[:, None])[:, 0]
    lstar_type = next_table.type[lstar]
    lstar_is_car = lstar_type == TYPE_CAR

    occ = cfg.track.occupancy if occupancy is None else occupancy
    active = is_car_row & has_budgeted_pt & sufficient

    # verdict lattice (ssc.cpp:1323-1421)
    one_label = active & (n_labels == 1)
    verdict_dyn = active & ((n_labels == 0)
                            | ((n_labels == 1) & (ratio1 < occ)
                               & lstar_is_car))
    is_split = one_label & (ratio1 < occ) & ~lstar_is_car
    is_absorb = one_label & (ratio1 >= occ) & lstar_is_car
    is_merge = active & (n_labels > 1)
    qual = (is_merge[:, None] & hit_any
            & (next_table.type[None, :] == TYPE_CAR) & (ratio >= occ))
    merge_has_rows = qual.any(1)

    state = torch.where(verdict_dyn, STATE_DYNAMIC, prev_table.state)
    state = torch.where(is_split | is_merge | is_absorb, STATE_STATIC, state)
    # split: prev cluster adopts the target's type (ssc.cpp:1354)
    prev_type = torch.where(is_split, lstar_type, prev_table.type)
    prev_table = prev_table.replace(state=state.to(torch.int32),
                                    type=prev_type)

    # ---- allocate next-frame rows for splits and merges
    needs_new = is_split | (is_merge & merge_has_rows)
    new_rank = torch.cumsum(needs_new.to(torch.int32), 0,
                            dtype=torch.int32) - 1
    free = ~next_table.valid
    free_rank = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
    rank_to_row = _scatter(C, -1, torch.where(free, free_rank, C - 1),
                           torch.where(free, c_iota, -1), "amax")
    got_row = needs_new & (new_rank < free.sum())
    new_row = torch.where(
        got_row, rank_to_row[torch.clamp(new_rank, 0, C - 1).long()], C)
    got_row = got_row & (new_row >= 0) & (new_row < C)
    overflow = (needs_new & ~got_row).sum().to(torch.int32)
    new_row = torch.where(got_row, new_row, C)

    n_dyn = verdict_dyn.sum().to(torch.int32)
    if not cfg.track.enable_compensation:
        # "-TC" ablation: verdicts only, no next-frame mutations
        return (prev_table, next_table, next_grid, counter, n_dyn,
                torch.zeros((), dtype=torch.int32, device=device),
                track_overflow, pc)

    # ---- split: carve hit voxels of lstar into the new row
    # (ssc.cpp:1355-1374); conflicts resolve to the min new row
    uc_safe = torch.clamp(u_c, 0, C - 1).long()
    pair_split = ((u_c < C) & is_split[uc_safe] & (u_l == lstar[uc_safe])
                  & got_row[uc_safe])
    carve = _scatter(G, _INT_MAX, u_v,
                     torch.where(pair_split, new_row[uc_safe], _INT_MAX),
                     "amin")
    next_grid_mut = torch.where(carve != _INT_MAX, carve, next_grid)

    # ---- merge: absorb qualifying car rows into the new row
    # (ssc.cpp:1396-1421); a row claimed twice goes to the min new row
    claim = torch.where(qual & got_row[:, None], new_row[:, None], _INT_MAX)
    absorb = claim.min(0).values                  # [C] target or INT_MAX
    lut = absorb[torch.clamp(next_grid_mut, 0, C - 1).long()]
    next_grid_mut = torch.where((next_grid_mut >= 0) & (lut != _INT_MAX),
                                lut, next_grid_mut)

    # ---- mutated next table
    nr_safe = torch.clamp(new_row, 0, C - 1)
    new_is_row = _scatter(C, 0, nr_safe, got_row, "amax") > 0
    # type of new rows: split -> target's type; merge -> car
    new_type_src = torch.where(is_split, lstar_type, TYPE_CAR)
    new_type = _scatter(C, -1, nr_safe,
                        torch.where(got_row, new_type_src, -1), "amax")
    new_tid = _scatter(C, -1, nr_safe,
                       torch.where(got_row, prev_table.track_id, -1), "amax")

    merged_away = absorb != _INT_MAX
    valid_next = (next_table.valid & ~merged_away) | new_is_row
    type_next = torch.where(new_is_row, new_type, next_table.type)
    tid_next = torch.where(new_is_row, new_tid, next_table.track_id)
    # absorb with ratio >= occ onto a car: propagate the track id
    # (ssc.cpp:1381)
    prop = _scatter(C, _INT_MAX, torch.where(is_absorb, lstar, C - 1),
                    torch.where(is_absorb, prev_table.track_id, _INT_MAX),
                    "amin")
    tid_next = torch.where((prop != _INT_MAX) & ~new_is_row, prop, tid_next)

    nvox = segment_ops.grid_label_counts(next_grid_mut, C)
    valid_next = valid_next & ((nvox > 0) | ~next_table.valid | new_is_row)
    next_table_mut = next_table.replace(
        valid=valid_next, type=type_next, track_id=tid_next, n_voxels=nvox)
    return (prev_table, next_table_mut, next_grid_mut, counter, n_dyn,
            overflow, track_overflow, pc)


def track_window(xyz: torch.Tensor, point_voxel: torch.Tensor,
                 point_valid: torch.Tensor, label_grids: torch.Tensor,
                 tables: ClusterTable, poses: torch.Tensor,
                 cfg: PipelineConfig, init_carry=None,
                 occupancy: float | None = None) -> TrackingResult:
    """Tracking over a window of F frames, pair by pair
    (src/ssc.cpp:1450-1452). Inputs are stacked on the frame axis: xyz
    [F,N,3], point_voxel [F,N], point_valid [F,N], label_grids [F,G],
    tables [F,C], poses [F,4,4].

    `init_carry` (streaming): optional (table, label_grid, counter) of the
    window's first frame as the previous overlapping window left it;
    defaults to the first frame's own state with counter 0. `occupancy`
    overrides cfg.track.occupancy, the scalar threshold of the verdict
    lattice (eval/sweep.py sweeps it over one segmentation)."""
    F = xyz.shape[0]
    device = xyz.device
    zero = torch.zeros((), dtype=torch.int32, device=device)
    if init_carry is None:
        cur_table, cur_grid, counter = take(tables, 0), label_grids[0], zero
    else:
        cur_table, cur_grid, counter = init_carry
    row_ovf, track_ovf = zero, zero
    fin_tables, fin_grids, n_dyn, fin_pc = [], [], [], []
    for t in range(F - 1):
        T_np = geometry.inverse_se3(poses[t + 1]) @ poses[t]
        (prev_fin, nxt_table, nxt_grid, counter, nd, o, to, pc) = _pair_step(
            cur_table, cur_grid, take(tables, t + 1), label_grids[t + 1],
            xyz[t], point_voxel[t], point_valid[t], T_np, counter, cfg,
            occupancy)
        fin_tables.append(prev_fin)
        fin_grids.append(cur_grid)
        n_dyn.append(nd)
        fin_pc.append(pc)
        cur_table, cur_grid = nxt_table, nxt_grid
        row_ovf, track_ovf = row_ovf + o, track_ovf + to

    # the final frame is never a tracking 'prev' (same as the reference)
    G = cur_grid.shape[0]
    pv_last = torch.clamp(point_voxel[F - 1], 0, G - 1).long()
    fin_pc.append(torch.where(point_valid[F - 1] & (point_voxel[F - 1] >= 0),
                              cur_grid[pv_last], -1))
    return TrackingResult(
        tables=stack(fin_tables + [cur_table]),
        label_grids=torch.stack(fin_grids + [cur_grid]),
        point_cluster=torch.stack(fin_pc),
        n_dynamic=torch.stack(n_dyn + [zero]),
        new_row_overflow=row_ovf,
        track_point_overflow=track_ovf,
        counter=counter)
