"""Distributed pose-graph Gauss-Newton via Schur-complement reduction
(counterpart of dr_using_scv_od_tpu/parallel/schur_pgo.py; see its
docstring for the design).

  * keyframes split into B contiguous blocks, one per rank; the SEPARATOR
    set is each block's first keyframe plus both endpoints of every
    cross-block edge, so every edge's endpoints lie in (own block interior)
    U (separators);
  * each rank assembles its dense normal equations over
    [interior(K) + separators(S)] slots, eliminates its interior (float32
    solves, as the JAX function's) and contributes
    S_b = C_b - B_b^T A_b^{-1} B_b;
  * one all-reduce gives every rank the separator system, which every rank
    solves; interiors back-substitute locally and one more all-reduce
    assembles the update.

The dense blocks are assembled with the port's order-exact segment sums,
in the JAX function's scatter order (edge order, one block product after
another). `partition_graph` runs on the host in numpy. Gauge freedom is
fixed with a strong prior on keyframe 0 (a separator by construction).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models import posegraph as pgo
from ..ops import geometry, segment_ops
from . import mesh


class SchurPartition(NamedTuple):
    """Host-side static partition of a PoseGraph for B blocks."""
    sep_ids: np.ndarray     # [S] sorted global keyframe ids of separators
    edge_block: np.ndarray  # [B, E_max] edge index into the padded graph
    n_blocks: int
    block_size: int         # K = F / B


def partition_graph(pg: pgo.PoseGraph, n_blocks: int
                    ) -> Tuple[pgo.PoseGraph, SchurPartition]:
    """Pad edges to equal-size per-block shards and compute the separator
    set. F must be a multiple of n_blocks (pad the window upstream)."""
    F = int(pg.poses.shape[0])
    if F % n_blocks:
        raise ValueError(f"F={F} not divisible by n_blocks={n_blocks}")
    K = F // n_blocks
    ei = pg.edge_i.cpu().numpy()
    ej = pg.edge_j.cpu().numpy()
    blk_i, blk_j = ei // K, ej // K

    sep = {b * K for b in range(n_blocks)}
    cross = blk_i != blk_j
    # a cross-block edge is exact in the two-level partition only if both
    # endpoints are separators - lift them
    sep.update(ei[cross].tolist())
    sep.update(ej[cross].tolist())
    sep_ids = np.asarray(sorted(sep), np.int32)

    owner = np.minimum(blk_i, blk_j)
    counts = np.bincount(owner, minlength=n_blocks)
    e_max = max(int(counts.max()), 1)

    # pad the graph with weight-0 self edges at keyframe 0 (a separator)
    n_pad = n_blocks * e_max - len(ei)
    T = pg.edge_T
    padded = pgo.PoseGraph(
        poses=pg.poses,
        edge_i=torch.cat([pg.edge_i, pg.edge_i.new_zeros(n_pad)]),
        edge_j=torch.cat([pg.edge_j, pg.edge_j.new_zeros(n_pad)]),
        edge_T=torch.cat([T, torch.eye(4, dtype=T.dtype, device=T.device)
                          .expand(n_pad, 4, 4)]),
        edge_w=torch.cat([pg.edge_w, pg.edge_w.new_zeros(n_pad)]))

    # each block's own edges in edge order, then the padding edges in turn
    edge_block = np.empty((n_blocks, e_max), np.int64)
    pad_ptr = len(ei)
    for b in range(n_blocks):
        own = np.flatnonzero(owner == b)
        edge_block[b, :len(own)] = own
        edge_block[b, len(own):] = np.arange(pad_ptr,
                                             pad_ptr + e_max - len(own))
        pad_ptr += e_max - len(own)
    return padded, SchurPartition(sep_ids=sep_ids, edge_block=edge_block,
                                  n_blocks=n_blocks, block_size=K)


def _local_slot(g: torch.Tensor, my_block: int, sep_ids: torch.Tensor,
                K: int) -> torch.Tensor:
    """Global keyframe id -> local slot: [0,K) interior of my block,
    [K, K+S) separator."""
    pos = torch.clamp(torch.searchsorted(sep_ids, g), 0,
                      sep_ids.shape[0] - 1)
    return torch.where(sep_ids[pos] == g, K + pos, g - my_block * K)


def _block_step(poses, g: pgo.PoseGraph, sep_ids: torch.Tensor, K: int,
                my_block: int, lam: float, prior: float, group):
    """One distributed GN step; returns (new_poses replicated, sum r^2)."""
    S = sep_ids.shape[0]
    L = K + S
    F = poses.shape[0]
    device = poses.device
    g = g._replace(poses=poses)
    r = pgo.residuals(g)                             # [E,6] (weighted once)
    Ji, Jj = pgo._edge_jacobians(g)
    w = g.edge_w[:, None, None]
    si = _local_slot(g.edge_i.long(), my_block, sep_ids, K)
    sj = _local_slot(g.edge_j.long(), my_block, sep_ids, K)

    # dense local normal equations over L slots, in the JAX function's
    # scatter order: (si, si), (si, sj), (sj, si), (sj, sj), then g
    JiW, JjW = Ji * w, Jj * w                        # weight once per J
    blocks = [(si, si, JiW, JiW), (si, sj, JiW, JjW),
              (sj, si, JjW, JiW), (sj, sj, JjW, JjW)]
    H = segment_ops.segment_sum(
        torch.cat([torch.einsum('eba,ebc->eac', A, B).reshape(-1, 36)
                   for _, _, A, B in blocks]),
        torch.cat([a * L + b for a, b, _, _ in blocks]), L * L)
    gvec = segment_ops.segment_sum(
        torch.cat([-torch.einsum('eba,eb->ea', JiW, r),
                   -torch.einsum('eba,eb->ea', JjW, r)]),
        torch.cat([si, sj]), L)
    Hm = H.reshape(L, L, 6, 6).permute(0, 2, 1, 3).reshape(L * 6, L * 6)
    gv = gvec.reshape(L * 6)

    # interior slots that are actually separators get a decoupled identity
    # row (their update flows through the separator system)
    blk_ids = my_block * K + torch.arange(K, device=device)
    pos = torch.clamp(torch.searchsorted(sep_ids, blk_ids), 0, S - 1)
    int_valid = sep_ids[pos] != blk_ids                     # [K]
    ivm = int_valid.repeat_interleave(6)                    # [K*6]

    k6 = K * 6
    A = torch.where(ivm[:, None] & ivm[None, :], Hm[:k6, :k6], 0.0)
    A = A + torch.diag(torch.where(ivm, lam, 1.0))
    B = torch.where(ivm[:, None], Hm[:k6, k6:], 0.0)
    C = Hm[k6:, k6:]
    gi = torch.where(ivm, gv[:k6], 0.0)
    gs = gv[k6:]

    AinvB = torch.linalg.solve(A, B)                        # [6K, 6S]
    Ainvg = torch.linalg.solve(A, gi)                       # [6K]
    # global separator system: one all-reduce; lam + gauge prior added once
    sys_ = torch.cat([C - B.T @ AinvB, (gs - B.T @ Ainvg)[:, None]], 1)
    dist.all_reduce(sys_, group=group)
    diag_prior = torch.full((S * 6,), lam, device=device)
    diag_prior[:6] += prior
    xs = torch.linalg.solve(sys_[:, :-1] + torch.diag(diag_prior),
                            sys_[:, -1])                    # [6S]

    # local back-substitution
    xi = torch.where(ivm, Ainvg - AinvB @ xs, 0.0)          # [6K]

    # the global update: interiors (all-reduced) + separators
    dx = torch.zeros((F, 6), device=device)
    dx[blk_ids] = xi.reshape(K, 6) * int_valid[:, None]
    err = torch.sum(r * r).reshape(1)
    both = torch.cat([dx.reshape(-1), err])
    dist.all_reduce(both, group=group)
    dx = both[:-1].reshape(F, 6)
    dx[sep_ids.long()] = xs.reshape(S, 6)
    dx[0] = 0.0                                             # gauge
    return poses @ geometry.exp_se3(dx), both[-1]


def optimize_schur(pg: pgo.PoseGraph, gn_iters: int = 8, lam: float = 1e-4,
                   prior_w: float = 1e6, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed Schur-complement Gauss-Newton, called on every rank of
    `group` with the whole graph, one keyframe block per rank.

    Returns (optimized poses [F,4,4], final error scalar), the same on
    every rank."""
    W, r = mesh.world_size(group), mesh.rank(group)
    padded, part = partition_graph(pg, W)
    eb = torch.as_tensor(part.edge_block[r], device=pg.poses.device)
    g = pgo.PoseGraph(poses=pg.poses, edge_i=padded.edge_i[eb],
                      edge_j=padded.edge_j[eb], edge_T=padded.edge_T[eb],
                      edge_w=padded.edge_w[eb])
    sep_ids = torch.as_tensor(part.sep_ids, device=pg.poses.device).long()
    prior = prior_w if part.sep_ids[0] == 0 else 0.0
    poses, err = pg.poses, None
    for _ in range(gn_iters):
        poses, err = _block_step(poses, g, sep_ids, part.block_size, r, lam,
                                 prior, group)
    return poses, err
