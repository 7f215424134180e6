"""Patchwork ground segmentation (counterpart of
dr_using_scv_od_tpu/models/patchwork.py:103-253; reference
include/patchwork.h:38-504).

Points are binned into Concentric-Zone-Model patches; per patch, the LPR
seed height comes from a z histogram, a plane is fitted three times to the
points under it, and the uprightness / elevation / flatness rules accept
or reject the patch. Every per-patch sum is a segment sum keyed by patch
id (`segment_ops.segment_sum`), where the JAX package multiplies by a
[P, N] one-hot selector (a TPU device), and per-point reads of per-patch
values are plain indexing.

Semantics kept from the reference: points with r outside
(min_range, max_range] or z < -1.8 * sensor_height reach neither output;
patches with <= num_min_pts points are skipped; plane normals point up.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import PatchworkConfig
from ..ops import geometry, segment_ops
from ..ops import plane as plane_ops

_NB = 128  # z-histogram bins per patch


class PatchworkResult(NamedTuple):
    ground: torch.Tensor        # [N] bool accepted ground points
    nonground: torch.Tensor     # [N] bool rejected / non-ground points
    dropped: torch.Tensor       # [N] bool never reached either output
    patch_normal: torch.Tensor  # [P,3]
    patch_mean_z: torch.Tensor  # [P]


def _patch_tables(cfg: PatchworkConfig):
    """Per-patch elevation/flatness threshold slot (-1 when the patch's
    concentric ring is past num_rings_of_interest), patchwork.h:351-353."""
    thr_slot = []
    concentric = 0
    for zone, (ns, nr) in enumerate(zip(cfg.num_sectors_each_zone,
                                        cfg.num_rings_each_zone)):
        for ring in range(nr):
            slot = ring + 2 * zone
            use = concentric < cfg.num_rings_of_interest
            thr_slot += [slot if use and slot < len(cfg.elevation_thr)
                         else -1] * ns
            concentric += 1
    return thr_slot


def _patch_id(xyz: torch.Tensor, valid: torch.Tensor,
              cfg: PatchworkConfig) -> torch.Tensor:
    """Flat patch id per point (pc2czm, patchwork.h:431-459); P for
    out-of-range, too-low or invalid points."""
    x, y = xyz[..., 0], xyz[..., 1]
    r = geometry.sqrt_f32(x * x + y * y)
    theta = torch.atan2(y, x)
    theta = torch.where(y < 0, theta + 2.0 * math.pi, theta)

    P = cfg.num_patches
    pid = torch.full(r.shape, P, dtype=torch.int32, device=xyz.device)
    base = 0
    mrs = cfg.min_ranges + (cfg.max_range,)
    for zone in range(cfg.num_zones):
        ns, nr = cfg.num_sectors_each_zone[zone], cfg.num_rings_each_zone[zone]
        ring_size, sector_size = cfg.ring_sizes[zone], cfg.sector_sizes[zone]
        hi = mrs[zone + 1] if zone < 3 else cfg.max_range
        in_zone = (r > mrs[zone]) & (r <= hi)
        ring = torch.clamp(geometry.div_exact(r - mrs[zone], ring_size),
                           max=nr - 1).to(torch.int32)
        sect = torch.clamp(geometry.div_exact(theta, sector_size),
                           max=ns - 1).to(torch.int32)
        ring = torch.clamp(ring, 0, nr - 1)
        sect = torch.clamp(sect, 0, ns - 1)
        pid = torch.where(in_zone, base + ring * ns + sect, pid)
        base += ns * nr
    too_low = xyz[..., 2] < -1.8 * cfg.sensor_height
    return torch.where(valid & ~too_low, pid, P)


def _psum(mask: torch.Tensor, feats: torch.Tensor, pid: torch.Tensor,
          P: int) -> torch.Tensor:
    """[P, F] per-patch sums of the masked rows of feats [N, F]."""
    return segment_ops.segment_sum(feats * mask[:, None].to(feats.dtype),
                                   pid, P)


def _z_histogram(xyz: torch.Tensor, pid: torch.Tensor, cfg: PatchworkConfig):
    """The LPR seed histogram: (in_hist [N] bool, counts [P, NB] int32,
    z sums [P, NB]) of the z bins per patch. Zone 0 skips the points below
    the adaptive margin (patchwork.h:245-253)."""
    P = cfg.num_patches
    binned = pid < P
    pid_c = torch.clamp(pid, 0, P - 1).long()
    z = xyz[:, 2]
    n_zone0 = cfg.num_sectors_each_zone[0] * cfg.num_rings_each_zone[0]
    margin = cfg.adaptive_seed_selection_margin * cfg.sensor_height
    in_hist = binned & ~((pid_c < n_zone0) & (z < margin))
    z_lo = -1.8 * cfg.sensor_height          # points below got erased
    z_hi = z_lo + 8.0                        # seeds live near the ground
    zbin = torch.clamp(geometry.div_exact(z - z_lo, z_hi - z_lo) * _NB, 0,
                       _NB - 1).to(torch.int32)
    zoh = (zbin[:, None] == torch.arange(_NB, dtype=torch.int32,
                                         device=xyz.device)[None, :])
    zoh = (zoh & in_hist[:, None]).to(xyz.dtype)
    both = _psum(in_hist, torch.cat([zoh, zoh * z[:, None]], dim=1), pid, P)
    return in_hist, both[:, :_NB].to(torch.int32), both[:, _NB:]


def _moment_feats(xyz: torch.Tensor) -> torch.Tensor:
    """[N, 10] plane-fit moments (1, x, y, z, xx, yy, zz, xy, xz, yz)."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    return torch.stack([torch.ones_like(x), x, y, z, x * x, y * y, z * z,
                        x * y, x * z, y * z], dim=-1)


def estimate_ground(xyz: torch.Tensor, valid: torch.Tensor,
                    cfg: PatchworkConfig) -> PatchworkResult:
    """Batched Patchwork over xyz [N,3] f32 with valid [N] bool."""
    P = cfg.num_patches
    device = xyz.device

    pid = _patch_id(xyz, valid, cfg)
    binned = pid < P
    pid_c = torch.clamp(pid, 0, P - 1).long()
    z = xyz[:, 2]
    counts = segment_ops.grid_label_counts(pid, P)

    # ---- LPR seed height via a per-patch z histogram
    in_hist, hist, zsum = _z_histogram(xyz, pid, cfg)
    cum = torch.cumsum(hist, dim=1)
    need = torch.clamp(torch.clamp_min(cum[:, -1], 1), max=cfg.num_lpr)
    lpr_bin = torch.argmax((cum >= need[:, None]).to(torch.int8), dim=1)
    take = cum.gather(1, lpr_bin[:, None])[:, 0]
    zsum_cum = torch.cumsum(zsum, dim=1).gather(1, lpr_bin[:, None])[:, 0]
    lpr_height = zsum_cum / torch.clamp_min(take, 1)

    lpr_pt = torch.where(binned, lpr_height[pid_c], 0.0)
    seeds = in_hist & (z < (lpr_pt + cfg.th_seeds))

    # ---- iterative plane fit on per-patch moment sums
    moment_feats = _moment_feats(xyz)

    def fit(mask):
        m = _psum(mask, moment_feats, pid, P)
        n = m[:, 0]
        sn = torch.clamp_min(n, 1.0)
        mx, my, mz = m[:, 1] / sn, m[:, 2] / sn, m[:, 3] / sn
        cxx = m[:, 4] / sn - mx * mx
        cyy = m[:, 5] / sn - my * my
        czz = m[:, 6] / sn - mz * mz
        cxy = m[:, 7] / sn - mx * my
        cxz = m[:, 8] / sn - mx * mz
        cyz = m[:, 9] / sn - my * mz
        cov = torch.stack([
            torch.stack([cxx, cxy, cxz], -1),
            torch.stack([cxy, cyy, cyz], -1),
            torch.stack([cxz, cyz, czz], -1)], dim=-2)
        evals, evecs = plane_ops.eigh3x3(cov)
        normal = evecs[..., :, 0]
        sign = torch.where(normal[..., 2] < 0, -1.0, 1.0)
        normal = normal * sign[..., None]
        mean = torch.stack([mx, my, mz], dim=-1)
        return normal, mean, evals

    mask = seeds
    for _ in range(cfg.num_iter):
        normal, mean, evals = fit(mask)
        # th_dist_d = th_dist - d, d = -n . mean  (patchwork.h:229-231)
        th = cfg.th_dist + (normal * mean).sum(-1)
        coeff = torch.cat([normal, th[:, None]], dim=1)       # [P, 4]
        cpt = torch.where(binned[:, None], coeff[pid_c], 0.0)  # [N, 4]
        dist = xyz[:, 0] * cpt[:, 0] + xyz[:, 1] * cpt[:, 1] \
            + xyz[:, 2] * cpt[:, 2]
        mask = binned & (dist < cpt[:, 3])

    # ---- patch verdicts (patchwork.h:339-384)
    thr_slot = torch.tensor(_patch_tables(cfg), dtype=torch.int64,
                            device=device)
    uprightness = normal[:, 2].abs()
    elevation = mean[:, 2]
    surface_var = evals[:, 0] / torch.clamp_min(
        evals[:, 0] + evals[:, 1] + evals[:, 2], 1e-12)

    elev_thr = torch.tensor(cfg.elevation_thr, dtype=xyz.dtype, device=device)
    flat_thr = torch.tensor(cfg.flatness_thr, dtype=xyz.dtype, device=device)
    slot_t = torch.clamp(thr_slot, 0, len(cfg.elevation_thr) - 1)
    has_slot = thr_slot >= 0
    too_high = has_slot & (elevation > elev_thr[slot_t])
    flat_enough = has_slot & (surface_var < flat_thr[slot_t])

    upright = uprightness >= cfg.uprightness_thr
    accept = upright & (~too_high | flat_enough)
    processed = counts > cfg.num_min_pts             # patchwork.h:331

    ground = binned & processed[pid_c] & accept[pid_c] & mask
    nonground = binned & processed[pid_c] & ~ground
    ground = ground & valid
    nonground = nonground & valid
    dropped = valid & ~ground & ~nonground
    return PatchworkResult(ground=ground, nonground=nonground,
                           dropped=dropped, patch_normal=normal,
                           patch_mean_z=elevation)
