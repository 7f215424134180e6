"""Vectorized geometric primitives (counterpart of
dr_using_scv_od_tpu/ops/geometry.py:19-112): 2-D range, polar and azimuth
angles, rigid transforms. Operation order follows the JAX functions so the
two agree bit for bit where the arithmetic allows.
"""

from __future__ import annotations

import math

import torch

RAD2DEG = 180.0 / math.pi


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root. PyTorch's vectorized CPU
    sqrt is off by an ulp on ~0.5 % of inputs; a float64 root rounded to
    float32 is exact, as XLA's and the GPU's float32 roots are."""
    return torch.sqrt(x.double()).to(x.dtype)


def range2d(xyz: torch.Tensor) -> torch.Tensor:
    """2-D (x,y) range. Reference: pointDistance2d (utility.h:371-374)."""
    x, y = xyz[..., 0], xyz[..., 1]
    return sqrt_f32(x * x + y * y)


def polar_angle_deg(xyz: torch.Tensor) -> torch.Tensor:
    """Polar angle in degrees, [0, 360), 0 at the origin
    (getPolarAngle, utility.h:376-387)."""
    x, y = xyz[..., 0], xyz[..., 1]
    ang = torch.atan2(y, x)
    ang = torch.where(y < 0, ang + 2.0 * math.pi, ang)
    ang = torch.where((x == 0) & (y == 0), torch.zeros_like(ang), ang)
    return ang * RAD2DEG


def azimuth_deg(xyz: torch.Tensor) -> torch.Tensor:
    """Elevation angle in degrees (getAzimuth, utility.h:389-392)."""
    return torch.atan2(xyz[..., 2], range2d(xyz)) * RAD2DEG


def transform_points(T: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Apply a [4,4] rigid transform to [...,3] points
    (transformCloud, utility.h:395-406)."""
    return xyz @ T[:3, :3].T + T[:3, 3]


def inverse_se3(T: torch.Tensor) -> torch.Tensor:
    """Inverse of [...,4,4] rigid transforms: [R^T | -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -(Rt @ T[..., :3, 3:4])
    top = torch.cat([Rt, ti], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=T.dtype,
                          device=T.device).expand(T.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)
