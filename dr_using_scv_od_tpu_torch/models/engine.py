"""The streaming dynamic-aware LiDAR odometry & mapping engine (counterpart
of dr_using_scv_od_tpu/models/engine.py; see its docstring for the design):
raw scans in, a clean static map and an optimized trajectory out. Per
window of W scans, overlapping the previous window by one frame: GICP
scan-to-map odometry in refresh chunks, distance/rotation keyframe gating,
segmentation + SCV-OD tracking (`pipeline.run_window`, through the
cluster_labels kernel on the card), keyframe-local static submaps,
descriptor loop closure with GICP verification, pose-graph optimization
when a loop lands, periodic ERASOR cleaning, and checkpoints with exact
resume.

The state is one `EngineState` of fixed-shape tensors whose leaves are in
the JAX package's `jax.tree.leaves` order and keep its dtypes, and the
configs have the JAX class names, field order and defaults, so the two
packages write and read each other's checkpoints. What changes is the
control flow:
  * `process_window` is a plain function; `first` and `run_erasor` are
    Python flags and every `lax.scan` / `lax.map` is a Python loop;
  * each `lax.cond` becomes a Python `if` on one host read: at most
    `loop_top_k` reads of `propose` in `_window_loops` (an unproposed
    candidate is never verified) and one read of `accepted.any()` for
    the pose-graph solve;
  * the `mode='drop'` scatters write into buffers with one spare row that
    takes every dropped write and is cut off afterwards (torch has no drop
    mode); the kept writes go to distinct rows, so the result does not
    depend on the order in which the card stores them;
  * `jax.lax.top_k` becomes a stable descending sort, whose ties keep the
    lower flat index as top_k's do.
The device is the one the engine is built for: CPU tensors take the plain
path, CUDA tensors go through the kernels.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import warnings
from pathlib import Path
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..ops import geometry
from ..types import ClusterTable, _Fields, take
from ..utils import checkpoint as ckpt
from ..utils import timing
from . import erasor as erasor_mod
from . import gicp, pipeline, posegraph, scan_context

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    window: int = 8              # scans per processing window (>= 3)
    max_keyframes: int = 128     # K: pose / submap / descriptor budget
    submap_points: int = 4096    # P: static points kept per keyframe
    local_map_kf: int = 3        # keyframes in the odometry local map
    # keyframe selection gates (<= 0 disables that gate; both disabled =
    # every scan is a keyframe)
    kf_dist: float = 0.0         # metres moved since the last keyframe
    kf_rot: float = 0.0          # radians rotated since the last keyframe
    # odometry map refresh cadence: scans registered per frozen-target chunk
    odo_refresh_every: int = 2
    desc: scan_context.DescriptorConfig = dataclasses.field(
        default_factory=scan_context.DescriptorConfig)
    # loop closure
    loop_min_gap: int = 8        # minimum keyframe separation
    loop_min_score: float = 0.92  # descriptor similarity floor
    loop_top_k: int = 3          # distinct candidates GICP-verified/window
    loop_min_corr_frac: float = 0.15
    loop_max_rmse: float = 0.6
    loop_edge_weight: float = 3.0
    max_loop_edges: int = 32
    # pose graph
    pgo_gn_iters: int = 8
    pgo_cg_iters: int = 32
    # map cleaning
    erasor: erasor_mod.ErasorConfig = dataclasses.field(
        default_factory=erasor_mod.ErasorConfig)
    erasor_every: int = 0        # windows between ERASOR passes; 0 = final only
    # fault injection: an se(3) bias composed onto every odometry relative
    # transform (drift studies); loop measurements are not biased
    drift_bias: Tuple[float, ...] = (0.0,) * 6


@dataclasses.dataclass(frozen=True)
class EngineState(_Fields):
    n: torch.Tensor               # int32 - KEYFRAMES so far
    frames: torch.Tensor          # int32 - scans processed so far
    poses: torch.Tensor           # [K,4,4] current world_T_k estimates
    rel_T: torch.Tensor           # [K,4,4] keyframe odometry (k-1)_T_k
    kf_frame: torch.Tensor        # [K] int32 scan id of keyframe k (-1 unused)
    last_pose: torch.Tensor       # [4,4] pose of the last processed scan
    last_rel: torch.Tensor        # [4,4] last scan-to-scan relative motion
    submap_xyz: torch.Tensor      # [K,P,3] static points, keyframe-LOCAL
    submap_valid: torch.Tensor    # [K,P] bool
    submap_idx: torch.Tensor      # [K,P] int32 source point index (-1 unused)
    submap_frame: torch.Tensor    # [K,P] int32 scan id of slot p's source
    submap_fill: torch.Tensor     # [K] int32 write cursor per keyframe
    desc: torch.Tensor            # [K,R,S] place-recognition descriptors
    loop_i: torch.Tensor          # [L] int32 (-1 = unused)
    loop_j: torch.Tensor          # [L] int32
    loop_T: torch.Tensor          # [L,4,4] measured i_T_j
    loop_w: torch.Tensor          # [L] f32
    n_loops: torch.Tensor         # int32
    # streaming tracking carry (boundary frame of the last window)
    track_table: ClusterTable
    track_grid: torch.Tensor      # [G] int32
    track_counter: torch.Tensor   # int32
    # accumulated diagnostics (overflow discipline), int32 scalars
    row_overflow: torch.Tensor
    point_overflow: torch.Tensor
    submap_overflow: torch.Tensor  # a keyframe's OWN static points past P
    kf_overflow: torch.Tensor      # keyframes dropped past the K budget
    erasor_removed: torch.Tensor   # map points ERASOR invalidated
    odo_fallbacks: torch.Tensor    # registrations that fell back to the
    #                                constant-velocity prior


class WindowOutput(NamedTuple):
    removed: torch.Tensor         # [W-1,N] verdicts for judged frames
    poses: torch.Tensor           # [W,4,4] window SCAN poses (post-odometry)
    n_dynamic: torch.Tensor       # [W]
    odo_n_corr: torch.Tensor      # [W-1]
    odo_rmse: torch.Tensor        # [W-1]
    is_kf: torch.Tensor           # [W] bool - scan became a keyframe
    kf_slot: torch.Tensor         # [W] int32 - assigned keyframe slot
    loop_accepted: torch.Tensor   # [k] bool - loop edges landed this window
    loop_pair: torch.Tensor       # [k,2] int32 (i, j) or (-1, -1)
    loop_score: torch.Tensor      # [k] descriptor similarity of candidates
    loop_rmse: torch.Tensor       # [k] GICP verification residual (inf)
    loop_ncorr: torch.Tensor      # [k] GICP verification correspondences
    pgo_error: torch.Tensor       # final PGO residual (0 if not run)


def state_leaves(state: EngineState) -> List[torch.Tensor]:
    """The state's tensors in the JAX package's `jax.tree.leaves` order
    (fields in declaration order, the nested ClusterTable in its own)."""
    return ckpt.leaves(state)


def state_from_leaves(leaves) -> EngineState:
    """Inverse of `state_leaves`."""
    leaves = list(leaves)
    kw = {}
    for f in dataclasses.fields(EngineState):
        if f.name == "track_table":
            n = len(dataclasses.fields(ClusterTable))
            kw[f.name] = ClusterTable(*leaves[:n])
            leaves = leaves[n:]
        else:
            kw[f.name] = leaves.pop(0)
    if leaves:
        raise ValueError(f"{len(leaves)} leaves left over")
    return EngineState(**kw)


def _empty_table(cfg: PipelineConfig, device) -> ClusterTable:
    C = cfg.shapes.max_clusters
    return ClusterTable(
        valid=torch.zeros((C,), dtype=torch.bool, device=device),
        n_points=torch.zeros((C,), dtype=I32, device=device),
        n_voxels=torch.zeros((C,), dtype=I32, device=device),
        bbox_min=torch.zeros((C, 3), dtype=torch.float32, device=device),
        bbox_max=torch.zeros((C, 3), dtype=torch.float32, device=device),
        type=torch.full((C,), -1, dtype=I32, device=device),
        state=torch.full((C,), -1, dtype=I32, device=device),
        track_id=torch.full((C,), -1, dtype=I32, device=device))


def init_state(ec: EngineConfig, cfg: PipelineConfig,
               device: torch.device | str) -> EngineState:
    K, P, L = ec.max_keyframes, ec.submap_points, ec.max_loop_edges
    R, S = ec.desc.rings, ec.desc.sectors
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=I32, device=device)
    eye = torch.eye(4, **f32)
    zero = torch.zeros((), **i32)
    return EngineState(
        n=zero, frames=zero,
        poses=eye.expand(K, 4, 4).clone(), rel_T=eye.expand(K, 4, 4).clone(),
        kf_frame=torch.full((K,), -1, **i32),
        last_pose=eye, last_rel=eye,
        submap_xyz=torch.zeros((K, P, 3), **f32),
        submap_valid=torch.zeros((K, P), dtype=torch.bool, device=device),
        submap_idx=torch.full((K, P), -1, **i32),
        submap_frame=torch.full((K, P), -1, **i32),
        submap_fill=torch.zeros((K,), **i32),
        desc=torch.zeros((K, R, S), **f32),
        loop_i=torch.full((L,), -1, **i32),
        loop_j=torch.full((L,), -1, **i32),
        loop_T=eye.expand(L, 4, 4).clone(),
        loop_w=torch.zeros((L,), **f32),
        n_loops=zero,
        track_table=_empty_table(cfg, device),
        track_grid=torch.full((cfg.grid.bin_num,), -1, **i32),
        track_counter=zero,
        row_overflow=zero, point_overflow=zero, submap_overflow=zero,
        kf_overflow=zero, erasor_removed=zero, odo_fallbacks=zero)


def _row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[i] for a 0-d index tensor, without a host read."""
    return t.index_select(0, i.reshape(1).long())[0]


def _set_rows(buf: torch.Tensor, idx: torch.Tensor,
              val: torch.Tensor) -> torch.Tensor:
    """`buf.at[idx].set(val, mode='drop')` for idx in [0, len(buf)]: the
    writes go into a copy with one spare row that takes every dropped
    write (idx == len(buf)), which is then cut off. The kept indices must
    be distinct."""
    spare = torch.cat([buf, buf[:1]])
    spare[idx.long()] = val.to(buf.dtype)
    return spare[:-1]


# ---------------------------------------------------------------------------
# odometry


def _window_odometry(state: EngineState, xyz, valid, first: bool,
                     ec: EngineConfig, cfg: PipelineConfig):
    """Scan-to-map GICP over one window in the frame of its first scan,
    in refresh chunks (engine.py:222-315). Returns (A_T_t [W,4,4],
    n_corr [W-1], rmse [W-1], pose_A, n_fallback)."""
    W = xyz.shape[0]
    eye = torch.eye(4, dtype=xyz.dtype, device=xyz.device)
    pose_A = eye if first else state.last_pose
    A_inv = geometry.inverse_se3(pose_A)

    # local map: static submaps of the last `local_map_kf` keyframes,
    # re-anchored into frame A by the CURRENT pose estimates
    vm = gicp.build_voxel_map(xyz[0], valid[0], cfg.gicp)
    if not first:
        Kn = ec.local_map_kf
        start = torch.clamp(state.n - Kn, 0, ec.max_keyframes - Kn)
        rows = (start + torch.arange(Kn, device=xyz.device)).long()
        sm = state.submap_xyz[rows]
        sv = state.submap_valid[rows]
        T_ak = torch.einsum('ij,kjl->kil', A_inv, state.poses[rows])
        local = torch.einsum('kij,kpj->kpi', T_ak[:, :3, :3], sm) \
            + T_ak[:, None, :3, 3]
        vm = vm.merge(gicp.build_voxel_map(
            local.reshape(-1, 3), sv.reshape(-1), cfg.gicp))

    if first:
        # cold start: sweep yaw hypotheses for the very first pair
        rel0 = gicp.register_global(xyz[1], valid[1], vm, cfg.gicp).T
    else:
        rel0 = state.last_rel

    chunk = max(int(ec.odo_refresh_every), 1)
    steps = list(range(1, W))
    T_prev, rel_prev = eye, rel0
    out_T, out_nc, out_rm, out_fell = [], [], [], []
    for c0 in range(0, len(steps), chunk):
        idxs = steps[c0:c0 + chunk]
        tgt_c, ccfg, tgt_f = gicp.build_targets(vm, cfg.gicp)
        T_c, oks = [], []
        for t in idxs:
            res = gicp.register_targets(xyz[t], valid[t], tgt_c, ccfg,
                                        tgt_f, cfg.gicp,
                                        T_init=T_prev @ rel_prev)
            # failure detection: lost correspondences, non-finite, or an
            # implausible jump fall back to constant velocity
            rel_cand = geometry.inverse_se3(T_prev) @ res.T
            ok = ((res.n_corr >= cfg.gicp.min_fallback_corr)
                  & torch.isfinite(rel_cand).all()
                  & (torch.linalg.vector_norm(rel_cand[:3, 3])
                     <= cfg.gicp.max_rel_motion))
            T_t = torch.where(ok, res.T, T_prev @ rel_prev)
            rel_prev = torch.where(ok, rel_cand, rel_prev)
            T_prev = T_t
            T_c.append(T_t)
            oks.append(ok)
            out_nc.append(res.n_corr)
            out_rm.append(res.rmse)
            out_fell.append(~ok)
        T_c = torch.stack(T_c)
        out_T.append(T_c)
        if c0 + chunk < len(steps):   # not the last chunk: refresh the map
            pts = xyz[idxs[0]:idxs[-1] + 1]              # [k,N,3]
            warped = torch.einsum('kij,knj->kni', T_c[:, :3, :3], pts) \
                + T_c[:, None, :3, 3]
            # a failed frame's points would pollute the map at a wrong pose
            ok_pts = valid[idxs[0]:idxs[-1] + 1] & torch.stack(oks)[:, None]
            vm = vm.merge(gicp.build_voxel_map(
                warped.reshape(-1, 3), ok_pts.reshape(-1), cfg.gicp))

    A_T = torch.cat([eye[None]] + out_T, dim=0)
    n_fall = torch.stack(out_fell).sum(dtype=I32)
    return (A_T, torch.stack(out_nc), torch.stack(out_rm), pose_A, n_fall)


# ---------------------------------------------------------------------------
# keyframe selection


def _keyframe_gate(state: EngineState, poses_win, first: bool,
                   ec: EngineConfig):
    """Distance/rotation-gated keyframe selection over the window's scans.
    Returns (is_kf [W] bool, slot [W] int32, rel_kf [W,4,4], n_end)."""
    W = poses_win.shape[0]
    gating = (ec.kf_dist > 0.0) or (ec.kf_rot > 0.0)
    if first:
        last_pose = torch.eye(4, dtype=poses_win.dtype,
                              device=poses_win.device)
    else:
        last_pose = _row(state.poses, torch.clamp_min(state.n - 1, 0))
    n_kf = state.n
    out_kf, out_slot, out_rel = [], [], []
    for f in range(W):
        pose = poses_win[f]
        is_new = (f > 0) or first
        if gating:
            d = torch.linalg.vector_norm(pose[:3, 3] - last_pose[:3, 3])
            R = last_pose[:3, :3].T @ pose[:3, :3]
            ang = torch.arccos(torch.clamp((torch.trace(R) - 1.0) * 0.5,
                                           -1.0, 1.0))
            hit = n_kf == 0   # the run's first keyframe is forced
            if ec.kf_dist > 0.0:
                hit = hit | (d >= ec.kf_dist)
            if ec.kf_rot > 0.0:
                hit = hit | (ang >= ec.kf_rot)
        else:
            hit = torch.ones((), dtype=torch.bool, device=pose.device)
        is_kf = hit & is_new
        out_kf.append(is_kf)
        out_slot.append(torch.where(is_kf, n_kf, torch.clamp_min(n_kf - 1, 0)))
        out_rel.append(geometry.orthonormalize_se3(
            geometry.inverse_se3(last_pose) @ pose))
        n_kf = n_kf + is_kf.to(I32)
        last_pose = torch.where(is_kf, pose, last_pose)
    return (torch.stack(out_kf), torch.stack(out_slot).to(I32),
            torch.stack(out_rel), n_kf)


# ---------------------------------------------------------------------------
# loop closure


def _window_loops(state: EngineState, xyz, valid, descs, slots, is_kf,
                  first: bool, ec: EngineConfig, cfg: PipelineConfig):
    """Descriptor retrieval for every new KEYFRAME of the window; GICP-
    verify the top-k distinct (query, candidate) pairs whose score clears
    `loop_min_score` (one host read each). Returns the updated loop edge
    table fields, the accepted flags, the pairs and the diagnostics."""
    W = xyz.shape[0]
    K = ec.max_keyframes
    L = ec.max_loop_edges
    device = xyz.device
    new0 = 0 if first else 1                # first new window-local frame
    Wq = W - new0

    q_slots = slots[new0:]
    ar_K = torch.arange(K, device=device)
    bank_valid = ar_K[None, :] <= (q_slots[:, None] - ec.loop_min_gap)
    ret = scan_context.similarity(descs[new0:], state.desc, bank_valid)
    # only keyframe queries can carry a pose-graph edge
    scores = torch.where(is_kf[new0:, None], ret.scores, -math.inf)

    # top-k over the FULL (query, candidate) score matrix; a stable
    # descending sort breaks ties by the lower flat index, as top_k does
    k_loops = max(1, min(int(ec.loop_top_k), Wq * K))
    flat = scores.reshape(-1)
    top_flat = torch.sort(flat, descending=True, stable=True)[1][:k_loops]
    top_scores = flat[top_flat]
    top_q = top_flat // K
    top_cand = (top_flat % K).to(I32)
    top_yaw = ret.yaw.reshape(-1)[top_flat]
    top_qslot = q_slots[top_q]
    top_local = top_q + new0

    # greedy distinct-candidate selection among the top-k
    enabled = [torch.ones((), dtype=torch.bool, device=device)]
    for r in range(1, k_loops):
        enabled.append((top_cand[r] != top_cand[:r]).all())

    def verify(r):
        # register the candidate's sparse static submap (source, sensor
        # frame of c) against the dense query scan (target, sensor frame
        # of q), warm-started by the descriptor's yaw; the measured q_T_c
        # is stored inverted as the edge c_T_q
        cand, q_local = top_cand[r:r + 1].long(), top_local[r:r + 1]
        sm, sv = state.submap_xyz[cand][0], state.submap_valid[cand][0]
        c, s = torch.cos(-top_yaw[r]), torch.sin(-top_yaw[r])
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        T_init = torch.stack([c, -s, zero, zero, s, c, zero, zero,
                              zero, zero, one, zero,
                              zero, zero, zero, one]).reshape(4, 4)
        res = gicp.scan_to_scan(sm, sv, xyz[q_local][0], valid[q_local][0],
                                cfg.gicp, T_init=T_init)
        # absolute floor: an empty candidate submap must not let a
        # zero-correspondence registration into the graph
        min_corr = torch.clamp_min(
            ec.loop_min_corr_frac * sv.sum(dtype=I32),
            float(cfg.gicp.min_fallback_corr))
        ok = (res.n_corr >= min_corr) & (res.rmse < ec.loop_max_rmse)
        return geometry.inverse_se3(res.T), ok, res.rmse, res.n_corr

    li, lj = state.loop_i, state.loop_j
    lT, lw = state.loop_T, state.loop_w
    nl = state.n_loops
    ar_L = torch.arange(L, device=device)
    no_pair = torch.full((2,), -1, dtype=I32, device=device)
    acc_list, pair_list, rmse_list, ncorr_list = [], [], [], []
    for r in range(k_loops):
        propose = enabled[r] & (top_scores[r] >= ec.loop_min_score) \
            & (nl < ec.max_loop_edges)
        if bool(propose):
            T_edge, ok, v_rmse, v_ncorr = verify(r)
            sel = (ar_L == torch.clamp(nl, 0, L - 1)) & ok
            li = torch.where(sel, top_cand[r], li)
            lj = torch.where(sel, top_qslot[r], lj)
            lT = torch.where(sel[:, None, None], T_edge, lT)
            lw = torch.where(sel, ec.loop_edge_weight, lw)
            nl = nl + ok.to(I32)
            pair = torch.where(ok, torch.stack([top_cand[r], top_qslot[r]]),
                               no_pair)
        else:
            ok = torch.zeros((), dtype=torch.bool, device=device)
            v_rmse = torch.tensor(math.inf, device=device)
            v_ncorr = torch.zeros((), dtype=I32, device=device)
            pair = no_pair
        acc_list.append(ok)
        pair_list.append(pair)
        rmse_list.append(v_rmse)
        ncorr_list.append(v_ncorr)

    accepted = torch.stack(acc_list)
    pairs = torch.stack(pair_list)
    diag = (top_scores, torch.stack(rmse_list), torch.stack(ncorr_list))
    return (li, lj, lT, lw, nl), accepted, pairs, diag


# ---------------------------------------------------------------------------
# pose graph


def _run_pgo(state: EngineState, n_total, ec: EngineConfig):
    """Optimize all keyframe poses with odometry + loop edges."""
    K = ec.max_keyframes
    ei = torch.arange(K - 1, dtype=I32, device=state.poses.device)
    ew = (ei + 1 < n_total).to(torch.float32)
    pg = posegraph.PoseGraph(
        poses=state.poses,
        edge_i=torch.cat([ei, torch.clamp(state.loop_i, 0, K - 1)]),
        edge_j=torch.cat([ei + 1, torch.clamp(state.loop_j, 0, K - 1)]),
        edge_T=torch.cat([state.rel_T[1:], state.loop_T], dim=0),
        edge_w=torch.cat([ew, state.loop_w]))
    res = posegraph.optimize(pg, gn_iters=ec.pgo_gn_iters,
                             cg_iters=ec.pgo_cg_iters)
    return res.poses, res.final_error


# ---------------------------------------------------------------------------
# map maintenance


def _insert_submaps(state: EngineState, xyz, valid, removed, poses_all,
                    poses_win, slots, is_kf, frame_ids, ec: EngineConfig):
    """Cursor-based insertion of each judged frame's static points into
    its assigned keyframe's submap (uniform stride subsample, keyframe-
    local frame), engine.py:494-555. The frames run in order: each one's
    cursor depends on the writes of the one before."""
    Wj = removed.shape[0]
    K, P = state.submap_valid.shape
    N = xyz.shape[1]
    device = xyz.device
    arP = torch.arange(P, dtype=I32, device=device)
    ar_K = torch.arange(K, device=device)
    targets = torch.arange(1, P + 1, dtype=I32, device=device)

    # flat buffers with one spare row for the dropped writes (dest == K*P)
    fxyz = torch.cat([state.submap_xyz.reshape(K * P, 3),
                      torch.zeros((1, 3), device=device)])
    fval = torch.cat([state.submap_valid.reshape(K * P),
                      torch.zeros((1,), dtype=torch.bool, device=device)])
    fidx = torch.cat([state.submap_idx.reshape(K * P),
                      torch.zeros((1,), dtype=I32, device=device)])
    ffrm = torch.cat([state.submap_frame.reshape(K * P),
                      torch.zeros((1,), dtype=I32, device=device)])
    fill = state.submap_fill
    ovf = torch.zeros((), dtype=I32, device=device)
    for f in range(Wj):
        slot = torch.clamp(slots[f], 0, K - 1)
        in_budget = slots[f] < K
        fill_s = _row(fill, slot)
        budget = torch.where(in_budget, P - fill_s, 0)
        keep = valid[f] & ~removed[f]
        n_keep = keep.sum(dtype=I32)
        b1 = torch.clamp_min(budget, 1)
        stride = torch.clamp_min((n_keep + b1 - 1) // b1, 1)
        rank = torch.cumsum(keep.to(I32), 0, dtype=I32) - 1
        sel = keep & (rank % stride == 0)
        # slot p <- the (p+1)-th selected point, by binary search on the
        # inclusive selection count
        csel = torch.cumsum(sel.to(I32), 0, dtype=I32)
        idx = torch.searchsorted(csel, targets, right=False).to(I32)
        n_write = torch.clamp(torch.minimum(csel[-1], budget), 0, P)
        wmask = arP < n_write
        idx_safe = torch.clamp(idx, 0, N - 1)
        pts = xyz[f][idx_safe.long()]
        # keyframe-local coordinates: the frame's own keyframe keeps raw
        # sensor points; followers warp into their keyframe's frame
        T_loc = geometry.inverse_se3(_row(poses_all, slot)) @ poses_win[f]
        warped = pts @ T_loc[:3, :3].T + T_loc[:3, 3]
        pts = torch.where(is_kf[f], pts, warped)
        dest = torch.where(wmask, slot * P + fill_s + arP, K * P).long()
        fxyz[dest] = pts
        fval[dest] = True
        fidx[dest] = idx_safe
        ffrm[dest] = frame_ids[f]
        fill = fill + torch.where((ar_K == slot) & in_budget, n_write, 0
                                  ).to(I32)
        # overflow counts only a keyframe's OWN points past the budget
        ovf = ovf + torch.where(is_kf[f],
                                torch.clamp_min(csel[-1] - budget, 0),
                                0).to(I32)
    return (fxyz[:-1].reshape(K, P, 3), fval[:-1].reshape(K, P),
            fidx[:-1].reshape(K, P), ffrm[:-1].reshape(K, P), fill, ovf)


def world_map(state: EngineState) -> Tuple[torch.Tensor, torch.Tensor]:
    """The current static world map: [K*P,3] points + validity. Submaps
    are keyframe-local, so this reflects the latest pose estimates."""
    K = state.poses.shape[0]
    pts = torch.einsum('kij,kpj->kpi', state.poses[:, :3, :3],
                       state.submap_xyz) + state.poses[:, None, :3, 3]
    ar_K = torch.arange(K, device=pts.device)
    valid = state.submap_valid & (
        ar_K[:, None] < torch.clamp_min(state.n - 1, 0))
    return pts.reshape(-1, 3), valid.reshape(-1)


def _erasor_pass(state: EngineState, scan_xyz, scan_valid, pose,
                 ec: EngineConfig):
    """Clean the accumulated map against one scan taken at `pose`."""
    map_xyz, map_valid = world_map(state)
    warped = geometry.transform_points(pose, scan_xyz)
    res = erasor_mod.clean_map(map_xyz, map_valid, warped, scan_valid,
                               pose[:3, 3], ec.erasor)
    K, P = state.submap_valid.shape
    new_valid = state.submap_valid & ~res.dynamic.reshape(K, P)
    return new_valid, res.dynamic.sum(dtype=I32)


# ---------------------------------------------------------------------------
# the window step


def process_window(state: EngineState, xyz, intensity, valid,
                   first: bool, run_erasor: bool,
                   ec: EngineConfig, cfg: PipelineConfig
                   ) -> Tuple[EngineState, WindowOutput]:
    """One engine step over a window of W scans ([W,N,...], sensor frame).
    For continuing windows, scan 0 is the previous window's last scan."""
    W = xyz.shape[0]
    device = xyz.device
    frame_ids = state.frames - (0 if first else 1) \
        + torch.arange(W, dtype=I32, device=device)

    # ---- 1. odometry
    with timing.span("odometry"):
        A_T, n_corr, rmse, pose_A, n_fallback = _window_odometry(
            state, xyz, valid, first, ec, cfg)

    # fault injection: a constant se(3) bias on every relative transform
    if any(b != 0.0 for b in ec.drift_bias):
        bias = geometry.exp_se3(torch.tensor(ec.drift_bias, dtype=xyz.dtype,
                                             device=device))
        rel = geometry.inverse_se3(A_T[:-1]) @ A_T[1:]
        rel = torch.einsum('wij,jk->wik', rel, bias)
        A_T = torch.cat([A_T[:1], posegraph.odometry_chain(rel)[1:]], dim=0)

    rel_win = geometry.orthonormalize_se3(
        geometry.inverse_se3(A_T[:-1]) @ A_T[1:])
    poses_win = geometry.orthonormalize_se3(
        torch.einsum('ij,wjk->wik', pose_A, A_T))

    # ---- 2. keyframe selection + keyframe-table writes (past-budget
    # keyframes are dropped and counted, never overwrite)
    K = ec.max_keyframes
    is_kf, slots, rel_kf, n_end = _keyframe_gate(state, poses_win, first, ec)
    widx = torch.where(is_kf & (slots < K), slots, K)
    n_drop = (is_kf & (slots >= K)).sum(dtype=I32)
    state = state.replace(
        poses=_set_rows(state.poses, widx, poses_win),
        rel_T=_set_rows(state.rel_T, widx, rel_kf),
        kf_frame=_set_rows(state.kf_frame, widx, frame_ids),
        n=torch.clamp_max(n_end, K),
        frames=state.frames + (W if first else W - 1),
        last_pose=poses_win[-1], last_rel=rel_win[-1],
        kf_overflow=state.kf_overflow + n_drop,
        odo_fallbacks=state.odo_fallbacks + n_fallback)

    # descriptors: once per window frame, for the bank and the queries
    descs = torch.stack([scan_context.descriptor(xyz[f], valid[f], ec.desc)
                         for f in range(W)])
    state = state.replace(desc=_set_rows(state.desc, widx, descs))

    # ---- 3. segmentation + tracking (streaming carry)
    init_track = None if first else (state.track_table, state.track_grid,
                                     state.track_counter)
    res = pipeline.run_window(xyz, intensity, valid, poses_win, cfg,
                              init_track=init_track)
    state = state.replace(
        track_table=take(res.tables, W - 1), track_grid=res.label_grids[-1],
        track_counter=res.track_counter,
        row_overflow=state.row_overflow + res.new_row_overflow,
        point_overflow=state.point_overflow + res.track_point_overflow)

    # ---- 4. submaps for judged frames (all but the window's last)
    sub_xyz, sub_val, sub_idx, sub_frm, fill, ovf = _insert_submaps(
        state, xyz[:-1], valid[:-1], res.removed[:-1], state.poses,
        poses_win[:-1], slots[:-1], is_kf[:-1], frame_ids[:-1], ec)
    state = state.replace(submap_xyz=sub_xyz, submap_valid=sub_val,
                          submap_idx=sub_idx, submap_frame=sub_frm,
                          submap_fill=fill,
                          submap_overflow=state.submap_overflow + ovf)

    # ---- 5. loop closure (top-k distinct candidates)
    with timing.span("loops"):
        (li, lj, lT, lw, nl), accepted, pairs, loop_diag = _window_loops(
            state, xyz, valid, descs, slots, is_kf, first, ec, cfg)
    state = state.replace(loop_i=li, loop_j=lj, loop_T=lT, loop_w=lw,
                          n_loops=nl)

    # ---- 6. pose graph (only when a loop landed this window)
    if bool(accepted.any()):
        with timing.span("pgo"):
            poses, pgo_err = _run_pgo(state, state.n, ec)
        state = state.replace(poses=poses)
    else:
        pgo_err = torch.zeros((), device=device)

    # ---- 7. periodic map cleaning
    if run_erasor:
        new_valid, removed_cnt = _erasor_pass(
            state, xyz[-1], valid[-1], state.last_pose, ec)
        state = state.replace(
            submap_valid=new_valid,
            erasor_removed=state.erasor_removed + removed_cnt)

    out = WindowOutput(removed=res.removed[:-1], poses=poses_win,
                       n_dynamic=res.n_dynamic,
                       odo_n_corr=n_corr, odo_rmse=rmse,
                       is_kf=is_kf, kf_slot=slots,
                       loop_accepted=accepted, loop_pair=pairs,
                       loop_score=loop_diag[0], loop_rmse=loop_diag[1],
                       loop_ncorr=loop_diag[2],
                       pgo_error=pgo_err)
    return state, out


def finalize(state: EngineState, ec: EngineConfig,
             cfg: PipelineConfig) -> EngineState:
    """End of sequence: one more pose-graph solve if any loop landed, so
    the returned poses reflect every accepted edge."""
    if int(state.n_loops) > 0:
        with timing.span("pgo"):
            poses, _ = _run_pgo(state, state.n, ec)
        state = state.replace(poses=poses)
    return state


# ---------------------------------------------------------------------------
# host driver


def _numpy_tree(out: WindowOutput) -> WindowOutput:
    return WindowOutput(*(t.detach().cpu().numpy() for t in out))


class SlamEngine:
    """Host-side streaming driver: feed scans, get a map + trajectory.

    Owns the EngineState on `device`, the window re-batching (1-frame
    overlap), the checkpoint cadence and the numpy diagnostics. Scans fed
    as numpy arrays or tensors move to `device`; a CUDA device runs the
    kernels, the CPU the plain path."""

    def __init__(self, cfg: PipelineConfig, ec: Optional[EngineConfig] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 materialize_outputs: bool = True, *,
                 device: torch.device | str):
        self.cfg = cfg
        self.ec = ec or EngineConfig()
        self.device = torch.device(device)
        self.state = init_state(self.ec, cfg, self.device)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        # materialize_outputs=False keeps WindowOutputs on the device and
        # defers the keyframe-budget check to finalize()
        self.materialize_outputs = materialize_outputs
        self._pending: list = []
        self._first = True
        self._overlap = None
        self._frames = 0
        self._last_ckpt = 0
        self.windows = 0
        self.outputs: list = []

    @property
    def n_frames(self) -> int:
        """Scans processed so far (host-side counter)."""
        return self._frames

    @property
    def n_keyframes(self) -> int:
        return int(self.state.n)

    def _scan(self, xyz, intensity, valid):
        dev = self.device
        return (torch.as_tensor(xyz, dtype=torch.float32, device=dev),
                torch.as_tensor(intensity, dtype=torch.float32, device=dev),
                torch.as_tensor(valid, dtype=torch.bool, device=dev))

    def feed(self, xyz, intensity, valid) -> Optional[WindowOutput]:
        """Queue one scan; runs a window step when enough scans buffered.
        Returns the WindowOutput when a step ran, else None."""
        self._pending.append(self._scan(xyz, intensity, valid))
        need = self.ec.window if self._first else self.ec.window - 1
        if len(self._pending) < need:
            return None
        return self._run_window()

    def flush(self) -> Optional[WindowOutput]:
        """Process whatever scans remain (shorter final window)."""
        need_min = 2 if self._first else 1
        if len(self._pending) < need_min:
            if self._pending:
                warnings.warn(
                    f"flush(): {len(self._pending)} pending scan(s) cannot "
                    f"form a minimal window (need {need_min}) and will not "
                    "be processed; feed at least 2 scans total",
                    stacklevel=2)
            return None
        return self._run_window()

    def _check_budget(self) -> None:
        ovf = int(self.state.kf_overflow)
        if ovf > 0:
            raise ValueError(
                f"keyframe budget exhausted: {ovf} keyframe(s) past "
                f"max_keyframes={self.ec.max_keyframes} were dropped "
                "(their poses/submaps are NOT in the state). Enable "
                "keyframe gating (EngineConfig.kf_dist / kf_rot) so K "
                "covers the trajectory, or raise max_keyframes")

    def _run_window(self) -> WindowOutput:
        batch = self._pending
        self._pending = []
        if not self._first:
            batch = [self._overlap] + batch
        self.windows += 1
        with timing.span("window", window=self.windows):
            xyz, inten, valid = (torch.stack(c) for c in zip(*batch))
            run_er = (self.ec.erasor_every > 0
                      and self.windows % self.ec.erasor_every == 0)
            self.state, out = process_window(
                self.state, xyz, inten, valid, self._first, run_er,
                self.ec, self.cfg)
            self._frames += len(batch) if self._first else len(batch) - 1
            self._overlap = batch[-1]
            self._first = False
            self.outputs.append(_numpy_tree(out) if self.materialize_outputs
                                else out)
            if self.materialize_outputs:
                # in-graph writes past K are dropped; the host surfaces them
                self._check_budget()

        if (self.ckpt_dir and self.ckpt_every
                and self._frames - self._last_ckpt >= self.ckpt_every):
            self.checkpoint()
            self._last_ckpt = self._frames
        return self.outputs[-1]

    def finalize(self, final_erasor: bool = True) -> None:
        """Final PGO + optional last ERASOR sweep using the overlap scan."""
        if len(self._pending):
            self.flush()
        with timing.span("finalize"):
            self._check_budget()
            self.state = finalize(self.state, self.ec, self.cfg)
            if final_erasor and self._overlap is not None:
                xyz, _, valid = self._overlap
                new_valid, removed = _erasor_pass(
                    self.state, xyz, valid, self.state.last_pose, self.ec)
                self.state = self.state.replace(
                    submap_valid=new_valid,
                    erasor_removed=self.state.erasor_removed + removed)

    # -- results ----------------------------------------------------------

    def poses(self) -> np.ndarray:
        """[n_keyframes,4,4] optimized keyframe poses."""
        return self.state.poses[:self.n_keyframes].cpu().numpy()

    def kf_frames(self) -> np.ndarray:
        """[n_keyframes] scan id of each keyframe (for GT alignment)."""
        return self.state.kf_frame[:self.n_keyframes].cpu().numpy()

    def static_map(self) -> np.ndarray:
        pts, valid = world_map(self.state)
        return pts[valid].cpu().numpy()

    # -- checkpoint / resume ----------------------------------------------

    def _config_fingerprint(self) -> str:
        """Digest of every config field that shapes the EngineState; the
        same string as the JAX package's for equal configs."""
        return hashlib.sha256(repr((self.ec, self.cfg)).encode()).hexdigest()

    def checkpoint(self, path: Optional[str] = None) -> str:
        if self._overlap is None:
            raise RuntimeError(
                "checkpoint() before any window has run: nothing to save "
                "(feed at least one full window first)")
        path = path or str(Path(self.ckpt_dir or ".")
                           / f"engine_{self._frames:06d}")
        ov_x, ov_i, ov_v = self._overlap
        ckpt.save(path, {
            "leaves": {f"{i:04d}": leaf
                       for i, leaf in enumerate(state_leaves(self.state))},
            "overlap_xyz": ov_x, "overlap_int": ov_i, "overlap_val": ov_v,
            "windows": np.asarray(self.windows),
            "frames": np.asarray(self._frames),
            "config_sha": np.frombuffer(
                self._config_fingerprint().encode(), dtype=np.uint8),
        })
        return path

    @classmethod
    def resume(cls, path: str, cfg: PipelineConfig,
               ec: Optional[EngineConfig] = None,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 0, *,
               device: torch.device | str) -> "SlamEngine":
        eng = cls(cfg, ec, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                  device=device)
        data = ckpt.load(path)
        if "config_sha" in data:
            saved = bytes(np.asarray(data["config_sha"])).decode()
            now = eng._config_fingerprint()
            if saved != now:
                raise ValueError(
                    "checkpoint/config mismatch: the checkpoint was written "
                    "with a different EngineConfig/PipelineConfig "
                    f"(saved {saved[:12]}..., current {now[:12]}...); "
                    "resume with the original configs")
        tmpl = state_leaves(eng.state)
        got = [data["leaves"][k] for k in sorted(data["leaves"])]
        if len(got) != len(tmpl):
            raise ValueError(
                f"checkpoint has {len(got)} leaves, expected {len(tmpl)} - "
                "incompatible checkpoint")
        leaves = []
        for i, (a, want) in enumerate(zip(got, tmpl)):
            t = torch.from_numpy(np.array(a))
            if tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype:
                raise ValueError(
                    f"checkpoint leaf {i} is {t.dtype}{tuple(t.shape)}, "
                    f"expected {want.dtype}{tuple(want.shape)} - was the "
                    "checkpoint written with different max_keyframes/"
                    "submap_points/shape caps?")
            leaves.append(t.to(eng.device))
        eng.state = state_from_leaves(leaves)
        eng._overlap = eng._scan(data["overlap_xyz"], data["overlap_int"],
                                 data["overlap_val"])
        eng._first = False
        eng.windows = int(data["windows"])
        eng._frames = int(data["frames"])
        eng._last_ckpt = eng._frames
        return eng
