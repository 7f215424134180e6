"""Intensity calibration by local surface orientation (counterpart of
dr_using_scv_od_tpu/ops/intensity.py; reference
intensityCalibrationByCurvature, src/ssc.cpp:98-153, shipped disabled at
:234-235): divide each return's intensity by the cosine between its curved
voxel's normal and the viewing ray, clamped at `min_cos`, saturating at
`max_intensity`. Optional, as in the reference.

The per-voxel moments are one order-exact `segment_sum` of ten columns;
the normal is the smallest-eigenvalue vector of `plane.eigh3x3`. Its sign
does not matter: the cosine is taken in absolute value.
"""

from __future__ import annotations

import torch

from ..config import GridConfig
from . import plane as plane_ops, segment_ops
from .geometry import sqrt_f32


def calibrate_by_orientation(xyz: torch.Tensor, intensity: torch.Tensor,
                             point_voxel: torch.Tensor, valid: torch.Tensor,
                             grid: GridConfig, max_intensity: float = 255.0,
                             min_cos: float = 0.3,
                             min_pts: int = 4) -> torch.Tensor:
    """Returns calibrated intensity [N]; points in voxels with < min_pts
    keep their raw (clamped) intensity."""
    g = grid.bin_num
    ok = valid & (point_voxel >= 0)
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    s = segment_ops.segment_sum(
        torch.stack([torch.ones_like(x), x, y, z, x * x, x * y, x * z,
                     y * y, y * z, z * z], -1),
        torch.where(ok, point_voxel, -1), g)
    n, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz = s.unbind(-1)
    sn = torch.clamp_min(n, 1.0)
    mx, my, mz = sx / sn, sy / sn, sz / sn
    cxy = sxy / sn - mx * my
    cxz = sxz / sn - mx * mz
    cyz = syz / sn - my * mz
    cov = torch.stack([
        torch.stack([sxx / sn - mx * mx, cxy, cxz], -1),
        torch.stack([cxy, syy / sn - my * my, cyz], -1),
        torch.stack([cxz, cyz, szz / sn - mz * mz], -1),
    ], dim=-2)
    _, evecs = plane_ops.eigh3x3(cov)
    normal = evecs[..., :, 0]                       # [G, 3]

    pv = torch.clamp(point_voxel, 0, g - 1).long()
    nrm = normal[pv]
    ray = xyz / torch.clamp_min(
        sqrt_f32((xyz * xyz).sum(-1, keepdim=True)), 1e-6)
    cos = (nrm[:, 0] * ray[:, 0] + nrm[:, 1] * ray[:, 1]
           + nrm[:, 2] * ray[:, 2]).abs()
    cos = torch.clamp_min(cos, min_cos)

    inten = torch.clamp_max(intensity, max_intensity)
    has_normal = ok & (n[pv] >= min_pts)
    calibrated = torch.clamp_max(inten / cos, max_intensity)
    return torch.where(has_normal, calibrated, inten)
