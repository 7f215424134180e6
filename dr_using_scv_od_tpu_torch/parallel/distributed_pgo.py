"""Distributed pose-graph optimization: keyframe-block edge sharding
(counterpart of dr_using_scv_od_tpu/parallel/distributed_pgo.py; see its
docstring for the design).

  * edges sort (stably) by min keyframe id, so a contiguous edge shard is a
    keyframe block; each rank holds one shard;
  * pose estimates are replicated [F, 4, 4] on every rank;
  * `b`, every matrix-free H @ v product and the error are summed over the
    rank's edges (the port's order-exact per-node sums) and then over the
    ranks with one all-reduce each; the CG's dot products run on the
    replicated vectors and need no reduction;
  * every rank applies the same pose update, so no gather is needed.

Weight-0 identity edges make the shards equal-sized without changing the
optimum.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..models import posegraph as pgo
from ..ops import geometry
from . import mesh


def pad_and_sort_edges(pg: pgo.PoseGraph, n_shards: int) -> pgo.PoseGraph:
    """Sort edges by min endpoint (keyframe-block locality, ties in edge
    order) and pad with weight-0 self-edges to a multiple of n_shards."""
    order = torch.argsort(torch.minimum(pg.edge_i, pg.edge_j), stable=True)
    ei, ej = pg.edge_i[order], pg.edge_j[order]
    eT, ew = pg.edge_T[order], pg.edge_w[order]
    pad = (-ei.shape[0]) % n_shards
    if pad:
        ei = torch.cat([ei, ei.new_zeros(pad)])
        ej = torch.cat([ej, ej.new_zeros(pad)])
        eT = torch.cat([eT, torch.eye(4, dtype=eT.dtype, device=eT.device)
                        .expand(pad, 4, 4)])
        ew = torch.cat([ew, ew.new_zeros(pad)])
    return pgo.PoseGraph(poses=pg.poses, edge_i=ei, edge_j=ej, edge_T=eT,
                         edge_w=ew)


def _all_sum(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, group=group)
    return x


def optimize_distributed(pg: pgo.PoseGraph, gn_iters: int = 10,
                         cg_iters: int = 50, lam: float = 1e-4,
                         fix_first: bool = True, group=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Called on every rank of `group` with the whole graph. Returns
    (optimized poses [F,4,4], final error scalar), the same on every
    rank."""
    W, r = mesh.world_size(group), mesh.rank(group)
    pgs = pad_and_sort_edges(pg, W)
    shard = mesh.frame_block(pgs.edge_i.shape[0], r, W)
    g = pgo.PoseGraph(poses=pg.poses, edge_i=pgs.edge_i[shard],
                      edge_j=pgs.edge_j[shard], edge_T=pgs.edge_T[shard],
                      edge_w=pgs.edge_w[shard])
    F = pg.poses.shape[0]
    dtype, device = pg.poses.dtype, pg.poses.device
    gauge = torch.ones((F, 1), dtype=dtype, device=device)
    if fix_first:
        gauge[0] = 0.0
    plan = pgo._node_plan(g)
    w = g.edge_w[:, None]
    poses = pg.poses
    err = torch.zeros((), dtype=dtype, device=device)
    for _ in range(gn_iters):
        g = g._replace(poses=poses)
        res = pgo.residuals(g)
        jac = pgo._edge_jacobians(g)
        b = _all_sum(pgo._node_sum(plan, pgo._jt(jac[0], res, w),
                                   pgo._jt(jac[1], res, w)), group)
        b = -b * gauge

        x = torch.zeros((F, 6), dtype=dtype, device=device)
        rr, p = b, b
        for _ in range(cg_iters):
            hp = (_all_sum(pgo._hv(g, p, 0.0, plan, jac), group) * gauge
                  + lam * p) * gauge
            alpha = torch.sum(rr * rr) / torch.clamp_min(
                torch.sum(p * hp), 1e-12)
            x = x + alpha * p
            rr_new = rr - alpha * hp
            beta = torch.sum(rr_new * rr_new) / torch.clamp_min(
                torch.sum(rr * rr), 1e-12)
            p = rr_new + beta * p
            rr = rr_new
        poses = poses @ geometry.exp_se3(x * gauge)
        err = _all_sum(torch.sum(res * res), group)
    return poses, err
