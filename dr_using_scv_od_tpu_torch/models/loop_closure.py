"""Loop-closure detection by pose proximity and GICP verification
(counterpart of dr_using_scv_od_tpu/models/loop_closure.py; see its
docstring). The streaming engine retrieves loops by descriptor instead
(models/engine.py); this is the batch detector over a window of scans.

The candidate order is a stable sort of the F x F distance matrix, as
`jnp.argsort` is, so ties keep the lower flat index; the `lax.map` over
candidates is a Python loop over the static `max_candidates`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..config import PipelineConfig
from ..ops import geometry
from . import gicp


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    radius: float = 10.0        # candidate search radius (m)
    min_gap: int = 10           # minimum frame separation
    max_candidates: int = 8     # static K
    # verification: fraction of the source scan's valid points that must
    # find correspondences
    min_corr_frac: float = 0.25
    # Euclidean RMS bound on the aligned inliers (metres)
    max_rmse: float = 0.6
    edge_weight: float = 3.0


class LoopResult(NamedTuple):
    edge_i: torch.Tensor     # [K] int32 (-1 = unused row)
    edge_j: torch.Tensor     # [K]
    edge_T: torch.Tensor     # [K, 4, 4] measured i_T_j
    edge_w: torch.Tensor     # [K] weight, 0 for rejected/unused
    n_accepted: torch.Tensor


def detect(xyz: torch.Tensor, valid: torch.Tensor, poses: torch.Tensor,
           cfg: PipelineConfig, lc: Optional[LoopConfig] = None
           ) -> LoopResult:
    """xyz [F,N,3], valid [F,N], poses [F,4,4] (estimated)."""
    lc = lc or LoopConfig()
    F = poses.shape[0]
    K = lc.max_candidates
    device = poses.device

    t = poses[:, :3, 3]
    d = torch.linalg.vector_norm(t[:, None, :] - t[None, :, :], dim=-1)
    ar = torch.arange(F, device=device)
    gap = (ar[:, None] - ar[None, :]).abs()
    cand = (d < lc.radius) & (gap > lc.min_gap) & (ar[:, None] < ar[None, :])
    score = torch.where(cand, d, math.inf).reshape(-1)
    order = torch.argsort(score, stable=True)[:K]
    ok = torch.isfinite(score[order])
    ei = torch.where(ok, order // F, -1).to(torch.int32)
    ej = torch.where(ok, order % F, -1).to(torch.int32)

    T_edges, weights = [], []
    for k in range(K):
        use = ei[k] >= 0
        i_s = torch.clamp_min(ei[k:k + 1], 0).long()
        j_s = torch.clamp_min(ej[k:k + 1], 0).long()
        # register scan j against scan i, warm-started with the current
        # pose estimates
        Ti, Tj = poses[i_s][0], poses[j_s][0]
        vj, vi = valid[j_s][0], valid[i_s][0]
        res = gicp.scan_to_scan(xyz[j_s][0], vj & use, xyz[i_s][0], vi & use,
                                cfg.gicp,
                                T_init=geometry.inverse_se3(Ti) @ Tj)
        min_corr = lc.min_corr_frac * vj.sum(dtype=torch.int32)
        good = use & (res.n_corr >= min_corr) & (res.rmse < lc.max_rmse)
        T_edges.append(res.T)
        weights.append(torch.where(good, lc.edge_weight, 0.0))
    weights = torch.stack(weights)
    return LoopResult(edge_i=ei, edge_j=ej, edge_T=torch.stack(T_edges),
                      edge_w=weights,
                      n_accepted=(weights > 0).sum(dtype=torch.int32))
