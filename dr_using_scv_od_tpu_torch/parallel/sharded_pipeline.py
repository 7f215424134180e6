"""Multi-rank window pipeline: frame-block data parallelism with a ring halo
exchange for the tracking boundary (counterpart of
dr_using_scv_od_tpu/parallel/sharded_pipeline.py).

  * Segmentation is per-frame independent: each rank processes a
    contiguous block of frames.
  * Tracking couples only consecutive frames (src/ssc.cpp:1450-1452), so a
    rank needs exactly ONE remote frame: the first frame of its right
    neighbour's block. It arrives in one batched send / receive around the
    ring (the JAX package's `ppermute`).
  * DELIBERATE DIVERGENCE (as in the JAX package): the reference's tracking
    mutates frame t+1 before pair (t+1, t+2) runs. Sharding breaks the
    chain at block boundaries: the boundary pair is judged against the
    neighbour's *unmutated* first frame and the mutation to it is dropped.
    Verdicts remain per-block exact; only split/merge bookkeeping across
    the boundary differs.

The global last frame receives no verdicts (same as the reference); on the
last rank the wrapped-around halo's verdicts for its final frame are
masked out. Every rank returns the whole window's results.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.distributed as dist

from ..config import PipelineConfig
from ..models import pipeline as pipeline_mod
from ..models import tracking as tracking_mod
from ..types import STATE_DYNAMIC, STATE_UNKNOWN, ClusterTable
from . import mesh


def _halo(tables: ClusterTable, grids, poses, group) -> list:
    """The right neighbour's first frame (table fields, label grid, pose):
    every rank sends its own first frame to its left neighbour."""
    mine = ([getattr(tables, f.name)[0] for f in dataclasses.fields(tables)]
            + [grids[0], poses[0]])
    W, r = mesh.world_size(group), mesh.rank(group)
    if W == 1:
        # the ring of one rank is the identity (ppermute with perm
        # [(0, 0)]); a send to self is no message
        return mine
    out = mesh.pack(mine)
    inc = tuple(torch.empty_like(w) for w in out)
    ops = ([dist.P2POp(dist.isend, w, (r - 1) % W, group) for w in out]
           + [dist.P2POp(dist.irecv, w, (r + 1) % W, group) for w in inc])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return mesh.unpack(inc, mine)


def sharded_run_window(xyz: torch.Tensor, intensity: torch.Tensor,
                       valid: torch.Tensor, poses: torch.Tensor,
                       cfg: PipelineConfig, group=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distributed run_window, called on every rank of `group` (default:
    the world) with the whole window: frames split in equal blocks over the
    ranks. Returns (removed [F,N] bool, states [F,C] int32, n_dynamic [F]
    int32) of the whole window on every rank."""
    W, r = mesh.world_size(group), mesh.rank(group)
    F, N = xyz.shape[:2]
    blk = mesh.frame_block(F, r, W)
    xyz, intensity, valid, poses = (a[blk] for a in (xyz, intensity, valid,
                                                     poses))
    f = xyz.shape[0]
    C = cfg.shapes.max_clusters
    G = cfg.grid.bin_num

    frames = pipeline_mod.process_window(xyz, intensity, valid, poses, cfg)
    st = frames.state
    pt_valid = (st.point_voxel >= 0) & valid

    # ---- extended window: local frames + the halo as the (f+1)-th frame
    halo = _halo(st.clusters, st.label_grid, poses, group)
    names = [fl.name for fl in dataclasses.fields(st.clusters)]
    ext_tables = ClusterTable(**{
        n: torch.cat([getattr(st.clusters, n), h[None]])
        for n, h in zip(names, halo)})
    ext_grids = torch.cat([st.label_grid, halo[-2][None]])
    ext_poses = torch.cat([poses, halo[-1][None]])
    # the halo frame never acts as a tracking 'prev': pad its point arrays
    ext_xyz = torch.cat([xyz, torch.zeros_like(xyz[:1])])
    ext_pv = torch.cat([st.point_voxel, torch.full_like(st.point_voxel[:1],
                                                        -1)])
    ext_valid = torch.cat([pt_valid, torch.zeros_like(pt_valid[:1])])
    tr = tracking_mod.track_window(ext_xyz, ext_pv, ext_valid, ext_grids,
                                   ext_tables, ext_poses, cfg)

    tables = ClusterTable(**{n: getattr(tr.tables, n)[:f] for n in names})
    grids = tr.label_grids[:f]
    n_dyn = tr.n_dynamic[:f].clone()
    state = tables.state.clone()
    if r == W - 1:
        # mask the wrapped-around verdicts of the global final frame
        state[-1] = STATE_UNKNOWN
        n_dyn[-1] = 0
    tables = tables.replace(state=state)

    # final per-point verdicts
    pv_safe = torch.clamp(st.point_voxel, 0, G - 1).long()
    pc = torch.where(pt_valid, grids.gather(1, pv_safe), -1)
    stp = state.gather(1, torch.clamp(pc, 0, C - 1).long())
    removed = (pc >= 0) & (stp == STATE_DYNAMIC)
    if cfg.track.dynamic_bbox_sweep:
        removed = removed | pipeline_mod._dynamic_bbox_sweep(xyz, tables,
                                                             cfg)
    removed = removed & valid

    # ---- one gather of every rank's block
    mine = torch.cat([removed.reshape(-1).to(torch.int32),
                      state.reshape(-1), n_dyn])
    parts = [torch.empty_like(mine) for _ in range(W)]
    dist.all_gather(parts, mine, group=group)
    out = torch.stack(parts)
    return (out[:, :f * N].reshape(F, N).bool(),
            out[:, f * N:f * (N + C)].reshape(F, C),
            out[:, f * (N + C):].reshape(F))
