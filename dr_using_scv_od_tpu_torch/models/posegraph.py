"""SE(3) pose-graph optimization (counterpart of dr_using_scv_od_tpu/models/
posegraph.py; see its docstring for the design): a fixed-size edge table,
Gauss-Newton with matrix-free conjugate-gradient inner solves, and the
error e_ij = log(T_ij^-1 T_i^-1 T_j) under right-multiplicative updates.

What changes is the form of its loops and scatters:
  * the `lax.scan`s over Gauss-Newton steps and CG steps are Python loops
    with no host read: every step is a fixed sequence of tensor ops, so the
    card runs the whole solve without waiting on the host;
  * the per-node scatter-adds of `b` and of H @ v (`.at[edge].add`) go
    through one planned segment sum over the concatenated (edge_i, edge_j)
    rows: each node adds its rows one after another in edge order, as
    XLA's CPU scatter-add does, and never through float atomics, whose
    order would change from run to run on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import geometry, segment_ops


class PoseGraph(NamedTuple):
    poses: torch.Tensor      # [F, 4, 4] current estimates (world_T_i)
    edge_i: torch.Tensor     # [E] int32
    edge_j: torch.Tensor     # [E] int32
    edge_T: torch.Tensor     # [E, 4, 4] measured i_T_j
    edge_w: torch.Tensor     # [E] float32 weight (0 disables an edge)


class PgoResult(NamedTuple):
    poses: torch.Tensor
    final_error: torch.Tensor
    n_iters: torch.Tensor


def _log_so3(R: torch.Tensor) -> torch.Tensor:
    """[...,3,3] -> [...,3] rotation log, safe near identity."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    s = torch.where(theta < 1e-5, 0.5,
                    theta / (2.0 * torch.sin(theta + 1e-30)))
    return w * s[..., None]


def _log_se3(T: torch.Tensor) -> torch.Tensor:
    """Approximate se(3) log (first-order V^-1)."""
    return torch.cat([T[..., :3, 3], _log_so3(T[..., :3, :3])], dim=-1)


def _gather(poses: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return poses.index_select(0, idx.long())


def residuals(pg: PoseGraph) -> torch.Tensor:
    """[E, 6] weighted edge residuals."""
    Ti = _gather(pg.poses, pg.edge_i)
    Tj = _gather(pg.poses, pg.edge_j)
    pred = geometry.inverse_se3(Ti) @ Tj
    err = _log_se3(geometry.inverse_se3(pg.edge_T) @ pred)
    return err * pg.edge_w[:, None]


def _adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint for (v, w)-ordered twists: [[R, [t]x R], [0, R]]."""
    R = T[..., :3, :3]
    tR = geometry.hat(T[..., :3, 3]) @ R
    Z = torch.zeros_like(R)
    return torch.cat([torch.cat([R, tR], dim=-1),
                      torch.cat([Z, R], dim=-1)], dim=-2)


def _edge_jacobians(pg: PoseGraph):
    """J_j = I, J_i = -Ad(T_j^-1 T_i) for T_k <- T_k exp(xi_k)."""
    Ti = _gather(pg.poses, pg.edge_i)
    Tj = _gather(pg.poses, pg.edge_j)
    Ji = -_adjoint(geometry.inverse_se3(Tj) @ Ti)
    Jj = torch.eye(6, dtype=Ti.dtype, device=Ti.device).expand(Ji.shape)
    return Ji, Jj


class _NodeSum(NamedTuple):
    """Plan of the per-node sums over the rows [edge_i rows; edge_j rows]."""
    order: torch.Tensor
    seg_sorted: torch.Tensor
    num: int


def _node_plan(pg: PoseGraph) -> _NodeSum:
    F = pg.poses.shape[0]
    ids = torch.cat([pg.edge_i, pg.edge_j])
    return _NodeSum(*segment_ops.segment_plan(ids, F), F)


def _node_sum(plan: _NodeSum, rows_i: torch.Tensor,
              rows_j: torch.Tensor) -> torch.Tensor:
    """[F, 6]: out[k] = sum of rows_i over edges with edge_i == k, then
    rows_j over edges with edge_j == k, each in edge order."""
    return segment_ops.segment_sum_planned(
        torch.cat([rows_i, rows_j]), plan.order, plan.seg_sorted, plan.num)


def _jt(J: torch.Tensor, r: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum('eba,eb->ea', J, r) * w


def _hv(pg: PoseGraph, v: torch.Tensor, lam, plan: Optional[_NodeSum] = None,
        jac=None) -> torch.Tensor:
    """Matrix-free H @ v, H = J^T W J + lam I. v: [F, 6] -> [F, 6]."""
    Ji, Jj = jac if jac is not None else _edge_jacobians(pg)
    plan = plan if plan is not None else _node_plan(pg)
    w = pg.edge_w[:, None]
    vi = _gather(v, pg.edge_i)
    vj = _gather(v, pg.edge_j)
    re = (torch.einsum('eab,eb->ea', Ji, vi)
          + torch.einsum('eab,eb->ea', Jj, vj)) * w
    return _node_sum(plan, _jt(Ji, re, w), _jt(Jj, re, w)) + lam * v


def optimize(pg: PoseGraph, gn_iters: int = 10, cg_iters: int = 50,
             lam: float = 1e-4, fix_first: bool = True) -> PgoResult:
    """Gauss-Newton with matrix-free CG inner solves."""
    F = pg.poses.shape[0]
    dtype, device = pg.poses.dtype, pg.poses.device
    gauge = torch.ones((F, 1), dtype=dtype, device=device)
    if fix_first:
        gauge[0] = 0.0   # gauge-fix node 0
    plan = _node_plan(pg)
    poses = pg.poses
    err = torch.zeros((), dtype=dtype, device=device)
    for _ in range(gn_iters):
        g = pg._replace(poses=poses)
        r = residuals(g)                                  # [E, 6]
        jac = _edge_jacobians(g)
        w = g.edge_w[:, None]
        b = -_node_sum(plan, _jt(jac[0], r, w), _jt(jac[1], r, w)) * gauge

        # CG solve H x = b
        x = torch.zeros((F, 6), dtype=dtype, device=device)
        rr, p = b, b
        for _ in range(cg_iters):
            hp = _hv(g, p, lam, plan, jac) * gauge
            alpha = torch.sum(rr * rr) / torch.clamp_min(
                torch.sum(p * hp), 1e-12)
            x = x + alpha * p
            rr_new = rr - alpha * hp
            beta = torch.sum(rr_new * rr_new) / torch.clamp_min(
                torch.sum(rr * rr), 1e-12)
            p = rr_new + beta * p
            rr = rr_new
        poses = geometry.orthonormalize_se3(
            poses @ geometry.exp_se3(x * gauge))
        err = torch.sum(r * r)
    return PgoResult(poses=poses, final_error=err,
                     n_iters=torch.tensor(gn_iters, dtype=torch.int32,
                                          device=device))


def odometry_chain(rel_T: torch.Tensor) -> torch.Tensor:
    """Compose relative transforms [F-1, 4, 4] into world poses [F, 4, 4]
    (pose 0 = identity), in order, as the JAX package's `lax.scan`."""
    T = torch.eye(4, dtype=rel_T.dtype, device=rel_T.device)
    poses = [T]
    for rel in rel_T:
        T = T @ rel
        poses.append(T)
    return torch.stack(poses)


def make_odometry_graph(poses_init: torch.Tensor, rel_T: torch.Tensor,
                        loop_i: Optional[torch.Tensor] = None,
                        loop_j: Optional[torch.Tensor] = None,
                        loop_T: Optional[torch.Tensor] = None,
                        loop_w: Optional[torch.Tensor] = None) -> PoseGraph:
    """Sequential odometry edges + optional loop-closure edges."""
    F = poses_init.shape[0]
    device = poses_init.device
    ei = torch.arange(F - 1, dtype=torch.int32, device=device)
    ej = ei + 1
    ew = torch.ones((F - 1,), dtype=torch.float32, device=device)
    eT = rel_T
    if loop_i is not None:
        ei = torch.cat([ei, loop_i.to(torch.int32)])
        ej = torch.cat([ej, loop_j.to(torch.int32)])
        eT = torch.cat([eT, loop_T], dim=0)
        ew = torch.cat([ew, loop_w])
    return PoseGraph(poses=poses_init, edge_i=ei, edge_j=ej, edge_T=eT,
                     edge_w=ew)
