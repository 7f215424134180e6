"""Vectorized geometric primitives (counterpart of
dr_using_scv_od_tpu/ops/geometry.py:19-170): 2-D range, polar and azimuth
angles, rigid transforms, Euler poses, and the se(3) maps of GICP.
Operation order follows the JAX functions so the two agree bit for bit
where the arithmetic allows.
"""

from __future__ import annotations

import math

import torch

RAD2DEG = 180.0 / math.pi
DEG2RAD = math.pi / 180.0


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root. PyTorch's vectorized CPU
    sqrt is off by an ulp on ~0.5 % of inputs; a float64 root rounded to
    float32 is exact, as XLA's and the GPU's float32 roots are."""
    return torch.sqrt(x.double()).to(x.dtype)


def div_exact(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device. PyTorch's CUDA division by
    a Python scalar (or a CPU scalar tensor) multiplies by the scalar's
    reciprocal, which puts points on a bin edge into the other bin; a 0-dim
    divisor of x's dtype on x's device takes the true division. On the CPU
    this is `x / d` bit for bit. Every division by a scalar whose result is
    floored, ceiled, truncated or cast to an integer goes through here."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def range2d(xyz: torch.Tensor) -> torch.Tensor:
    """2-D (x,y) range. Reference: pointDistance2d (utility.h:371-374)."""
    x, y = xyz[..., 0], xyz[..., 1]
    return sqrt_f32(x * x + y * y)


def range3d(xyz: torch.Tensor) -> torch.Tensor:
    """3-D range of [..., >=3] points."""
    return sqrt_f32((xyz[..., :3] ** 2).sum(-1))


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
    return torch.cat([top, _bottom_row(top)], dim=-2)


def euler_to_matrix(roll: torch.Tensor, pitch: torch.Tensor,
                    yaw: torch.Tensor) -> torch.Tensor:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll), the convention of
    pcl::getTransformation used throughout the reference
    (e.g. src/ssc.cpp:1163, 1255-1256)."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr,
                     cy * sp * cr + sy * sr], -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr,
                     sy * sp * cr - cy * sr], -1),
        torch.stack([-sp, cp * sr, cp * cr], -1),
    ], dim=-2)


def pose_to_matrix(xyzrpy: torch.Tensor) -> torch.Tensor:
    """[..., 6] (x,y,z,roll,pitch,yaw) -> [...,4,4] homogeneous transform."""
    R = euler_to_matrix(xyzrpy[..., 3], xyzrpy[..., 4], xyzrpy[..., 5])
    return _se3(R, xyzrpy[..., :3, None])


def matrix_to_euler(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotations -> [..., 3] (roll, pitch, yaw), with the
    singularity guard of rotationMatrixToEulerAngles (utility.h:488-505)."""
    sy = sqrt_f32(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    x = torch.where(singular, torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
                    torch.atan2(R[..., 2, 1], R[..., 2, 2]))
    y = torch.atan2(-R[..., 2, 0], sy)
    z = torch.where(singular, torch.zeros_like(sy),
                    torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    return torch.stack([x, y, z], dim=-1)


# se(3) exponential and hat maps for the GICP Gauss-Newton solver
# (geometry.py:114-170).

def hat(w: torch.Tensor) -> torch.Tensor:
    """[...,3] -> [...,3,3] skew-symmetric matrix."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zeros], -1),
    ], dim=-2)


def _rodrigues(w: torch.Tensor):
    """(theta [...,1,1], W = hat(w / theta), I, R) with theta safe near 0."""
    theta = sqrt_f32((w * w).sum(-1, keepdim=True) + 1e-24)
    th = theta[..., None]
    W = hat(w / theta)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    R = eye + torch.sin(th) * W + (1.0 - torch.cos(th)) * (W @ W)
    return th, W, eye, R


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, numerically safe near theta=0."""
    return _rodrigues(w)[3]


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    """The rows (0, 0, 0, 1) under [..., 3, 4] blocks, filled on their
    device: a tensor built from a Python list is a copy from pageable host
    memory, which waits for the device's queue and cannot be captured into
    a CUDA graph."""
    row = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype,
                      device=top.device)
    row[..., 3] = 1.0
    return row


def _se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[...,3,3] rotations and [...,3,1] translations -> [...,4,4]."""
    top = torch.cat([R, t], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def orthonormalize_se3(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block of [...,4,4] transforms back onto SO(3)
    (Gram-Schmidt on columns), keeping the translation."""
    R = T[..., :3, :3]
    x = R[..., :, 0]
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    y = R[..., :, 1]
    y = y - (x * y).sum(-1, keepdim=True) * x
    y = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    z = torch.linalg.cross(x, y, dim=-1)
    return _se3(torch.stack([x, y, z], dim=-1), T[..., :3, 3:4])


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """[...,6] twist (v, w) -> [...,4,4], with the closed-form V matrix."""
    v, w = xi[..., :3], xi[..., 3:]
    th, W, eye, R = _rodrigues(w)
    WW = W @ W
    V = eye + (1.0 - torch.cos(th)) / th * W + (th - torch.sin(th)) / th * WW
    return _se3(R, V @ v[..., None])
