"""Frame-level place-recognition descriptor for loop-closure retrieval
(counterpart of dr_using_scv_od_tpu/models/scan_context.py; see its
docstring): a ring x sector max-height signature on the egocentric polar
grid, scored by cosine similarity maximized over sector shifts.

The per-cell max (`.at[flat].max`) is a `scatter_reduce("amax")` onto a
-inf fill, which is order-free, so the card and the CPU agree. `similarity`
also takes a batch of queries [..., R, S] at once (the JAX engine maps it
over the window's queries one at a time).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..ops.geometry import div_exact, sqrt_f32


@dataclasses.dataclass(frozen=True)
class DescriptorConfig:
    rings: int = 8
    sectors: int = 24
    min_range: float = 1.5
    max_range: float = 30.0
    # floor offset added to z so empty cells (0) sit below any real return
    z_offset: float = 3.0


def cell_index(xyz: torch.Tensor, valid: torch.Tensor,
               cfg: DescriptorConfig) -> torch.Tensor:
    """[N] int64 flat (ring, sector) cell of each point of the descriptor,
    rings * sectors for a point out of range or invalid."""
    r = sqrt_f32(xyz[:, 0] ** 2 + xyz[:, 1] ** 2)
    th = torch.atan2(xyz[:, 1], xyz[:, 0])
    th = torch.where(th < 0, th + 2 * math.pi, th)
    ok = valid & (r > cfg.min_range) & (r < cfg.max_range)
    ring = (div_exact(r - cfg.min_range, cfg.max_range - cfg.min_range)
            * cfg.rings).to(torch.int32)
    ring = torch.clamp(ring, 0, cfg.rings - 1)
    sect = (div_exact(th, 2 * math.pi) * cfg.sectors).to(torch.int32)
    sect = torch.clamp(sect, 0, cfg.sectors - 1)
    nc = cfg.rings * cfg.sectors
    return torch.where(ok, ring * cfg.sectors + sect, nc).long()


def descriptor(xyz: torch.Tensor, valid: torch.Tensor,
               cfg: DescriptorConfig) -> torch.Tensor:
    """[N,3] sensor-frame scan -> [rings, sectors] max-height signature."""
    nc = cfg.rings * cfg.sectors
    flat = cell_index(xyz, valid, cfg)
    z = torch.where(flat < nc, xyz[:, 2] + cfg.z_offset, -math.inf)
    d = torch.full((nc + 1,), -math.inf, dtype=xyz.dtype, device=xyz.device)
    d = d.scatter_reduce(0, flat, z, "amax")
    d = torch.where(torch.isfinite(d), d, 0.0)[:-1]
    return d.reshape(cfg.rings, cfg.sectors)


class Retrieval(NamedTuple):
    scores: torch.Tensor   # [..., K] best-shift cosine similarity
    shifts: torch.Tensor   # [..., K] int32 argmax sector shift
    yaw: torch.Tensor      # [..., K] f32 implied yaw of the candidate match


def similarity(query: torch.Tensor, bank: torch.Tensor,
               bank_valid: torch.Tensor) -> Retrieval:
    """Shift-max cosine similarity of `query` [..., R, S] against `bank`
    [K, R, S]; bank rows with `bank_valid` [..., K] False score -inf. The
    yaw converts the winning sector shift into the rotation that maps the
    candidate frame onto the query frame (GICP warm start)."""
    R, S = query.shape[-2:]
    rolls = torch.stack([torch.roll(query, s, dims=-1) for s in range(S)],
                        dim=-3)                              # [..., S, R, S]
    qn = rolls / torch.clamp_min(torch.linalg.vector_norm(
        rolls, dim=(-2, -1)), 1e-9)[..., None, None]
    bn = bank / torch.clamp_min(torch.linalg.vector_norm(
        bank, dim=(-2, -1)), 1e-9)[:, None, None]
    sim = torch.einsum('...ars,krs->...ka', qn, bn.to(qn.dtype))
    best = torch.argmax(sim, dim=-1).to(torch.int32)   # first maximum
    score = torch.amax(sim, dim=-1)
    score = torch.where(bank_valid, score, -math.inf)
    # rolling the query by `s` aligns it with the bank entry when the query
    # heading is rotated by -s sectors relative to the stored frame
    yaw = best.to(torch.float32) * (2 * math.pi / S)
    return Retrieval(scores=score, shifts=best, yaw=yaw)
