"""Batched closed-form 3x3 symmetric eigendecomposition and least-squares
plane fits (counterpart of dr_using_scv_od_tpu/ops/plane.py:17-129). The
eigensolver is written in scalar planes: each matrix entry and vector
component is its own [...] tensor, and only the results are stacked.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .geometry import sqrt_f32


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _select(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def eigh3x3(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (ascending) [...,3] and eigenvectors [...,3,3] (columns)
    of symmetric [...,3,3] batches: Smith's trigonometric closed form for
    the eigenvalues, cross products of (A - lambda I) rows for the vectors,
    with the same degenerate-spectrum fallbacks as the JAX function."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    isotropic = p2 <= 1e-18  # near-scalar matrix: all eigenvalues == q
    p = sqrt_f32(torch.where(isotropic, torch.ones_like(p2), p2 / 6.0))
    detB = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detB / (2.0 * (p * p * p)), -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e_hi = torch.where(isotropic, q, q + 2.0 * p * torch.cos(phi))
    e_lo = torch.where(isotropic, q,
                       q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0))
    e_mid = 3.0 * q - e_hi - e_lo
    evals = torch.stack([e_lo, e_mid, e_hi], dim=-1)

    zero, one = torch.zeros_like(a00), torch.ones_like(a00)

    def eigvec(lam):
        r0 = (a00 - lam, a01, a02)
        r1 = (a01, a11 - lam, a12)
        r2 = (a02, a12, a22 - lam)
        c01, c02, c12 = _cross(r0, r1), _cross(r0, r2), _cross(r1, r2)
        n01, n02, n12 = _dot(c01, c01), _dot(c02, c02), _dot(c12, c12)
        best = _select(n01 >= n02, c01, c02)
        bestn = torch.maximum(n01, n02)
        best = _select(bestn >= n12, best, c12)
        bestn = torch.maximum(bestn, n12)
        safe = bestn > 1e-24
        inv = sqrt_f32(torch.clamp_min(bestn, 1e-30))
        v = tuple(torch.where(safe, c / inv, zero) for c in best)
        return _select(safe, v, (zero, zero, one))

    v_lo = eigvec(e_lo)
    v_hi = eigvec(e_hi)
    d = _dot(v_hi, v_lo)
    v_hi = tuple(h - d * l for h, l in zip(v_hi, v_lo))
    nh = _dot(v_hi, v_hi)
    alt_a = _cross(v_lo, (one, zero, zero))
    alt_b = _cross(v_lo, (zero, one, zero))
    na, nb = _dot(alt_a, alt_a), _dot(alt_b, alt_b)
    alt = _select(na >= nb, alt_a, alt_b)
    nalt = torch.maximum(na, nb)
    use_alt = nh < 1e-12
    v_hi = _select(use_alt, alt, v_hi)
    nh = torch.where(use_alt, nalt, nh)
    nh = sqrt_f32(torch.clamp_min(nh, 1e-30))
    v_hi = tuple(c / nh for c in v_hi)
    v_mid = _cross(v_hi, v_lo)
    nm = sqrt_f32(torch.clamp_min(_dot(v_mid, v_mid), 1e-30))
    v_mid = tuple(c / nm for c in v_mid)
    evecs = torch.stack([torch.stack(v, dim=-1)
                         for v in (v_lo, v_mid, v_hi)], dim=-1)
    return evals, evecs


def masked_mean_cov(xyz: torch.Tensor, mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mean [...,3], population covariance [...,3,3] and count [...] of
    [..., K, 3] points under a [..., K] mask."""
    m = mask.to(xyz.dtype)
    n = m.sum(-1)
    safe_n = torch.clamp_min(n, 1.0)
    mean = (xyz * m[..., None]).sum(-2) / safe_n[..., None]
    d = (xyz - mean[..., None, :]) * m[..., None]
    cov = torch.einsum('...ki,...kj->...ij', d, d) / safe_n[..., None, None]
    return mean, cov, n


def fit_plane(xyz: torch.Tensor, mask: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """Least-squares plane per batch: (normal [...,3] with n_z >= 0,
    mean [...,3], eigenvalues ascending [...,3], n_pts [...])."""
    mean, cov, n = masked_mean_cov(xyz, mask)
    evals, evecs = eigh3x3(cov)
    normal = evecs[..., :, 0]          # smallest-eigenvalue direction
    sign = torch.where(normal[..., 2] < 0, -1.0, 1.0)
    return normal * sign[..., None], mean, evals, n
