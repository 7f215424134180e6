"""Voxelized GICP registration, scan-to-scan and scan-to-map (counterpart
of dr_using_scv_od_tpu/models/gicp.py:43-512; see its docstring for the
design: per-voxel Gaussians on a bounded Cartesian grid, plane-like
regularised weights in closed form, single-voxel correspondence, and
Gauss-Newton as outer correspondence passes around inner relinearised
steps).

Same math, names and component-major layout (mean [3, G], weight [6, G])
as the JAX package, so the tests compare like with like. What changes is
the form of its loops and reductions:
  * `register`'s `lax.while_loop` (stop when the first inner step of a
    pass moves no more than `tolerance`) has two drivers of one outer pass.
    Off a card, a Python loop reads that test on the host once per pass.
    On a card, every pass up to ceil(max_iters / inner_iters) runs and a
    pass after the stop is masked out on the device (`torch.where`, exact),
    so the result is the same bit for bit; the whole solve is one CUDA
    graph, captured once per shape and replayed, with no host read. The
    inner `fori_loop` and `register_global`'s `lax.map` over yaw
    hypotheses are Python loops.
  * `build_voxel_map` sums through `segment_ops.segment_sum`, sequential
    per voxel in point order, and `pool_voxel_map` adds each coarse
    voxel's children one after another in lexicographic order, as XLA's
    CPU scatter-add and reduce do: both equal the JAX CPU run bit for bit.
  * The per-step [30, N] row sum reduces in PyTorch's order, and the
    closed-form eigenvalues use PyTorch's acos/cos, so poses agree with the
    JAX package within the tolerances the tests state, not bit for bit.
The 6x6 solve and `exp_se3` stay plain PyTorch, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..config import GicpConfig
from ..ops import geometry, segment_ops
from ..utils import timing


class VoxelMap(NamedTuple):
    """Running Gaussian sums per Cartesian voxel; maps merge by addition."""
    n: torch.Tensor       # [G] f32
    sum_x: torch.Tensor   # [3, G]
    sum_xx: torch.Tensor  # [6, G] (xx, yy, zz, xy, xz, yz)
    n_oob: torch.Tensor   # scalar int32: valid points outside the grid

    def merge(self, other: "VoxelMap") -> "VoxelMap":
        return VoxelMap(self.n + other.n, self.sum_x + other.sum_x,
                        self.sum_xx + other.sum_xx,
                        self.n_oob + other.n_oob)


class GicpTarget(NamedTuple):
    """Per-voxel means and GICP weights, weight packed symmetric as
    (w00, w11, w22, w01, w02, w12)."""
    mean: torch.Tensor    # [3, G]
    weight: torch.Tensor  # [6, G]
    valid: torch.Tensor   # [G] bool


class GicpResult(NamedTuple):
    T: torch.Tensor            # [4, 4] target_T_source
    n_iters: torch.Tensor      # int32 outer correspondence passes
    final_error: torch.Tensor  # mean Mahalanobis cost (weighted)
    n_corr: torch.Tensor       # int32 correspondences at convergence
    rmse: torch.Tensor         # Euclidean RMS residual of inliers (metres)
    n_oob: torch.Tensor        # int32 valid source points outside the grid


# H (6x6) from the [30] accumulator vector S of gn_step:
# H = [[H_tt, -M], [-M^T, -A]] with H_tt, A symmetric.
_H_IDX = ((0, 1, 2, 6, 7, 8), (1, 3, 4, 9, 10, 11), (2, 4, 5, 12, 13, 14),
          (6, 9, 12, 15, 16, 17), (7, 10, 13, 16, 18, 19),
          (8, 11, 14, 17, 19, 20))
# captured solves kept per process (one per shape and config); a call that
# finds no room runs the same solve eagerly
MAX_GRAPHS = 8


def _grid_dims(cfg: GicpConfig):
    nxy = int(2 * cfg.xy_extent / cfg.voxel_size)
    nz = int((cfg.z_max - cfg.z_min) / cfg.voxel_size)
    return nxy, nz


def _voxel_index_s(x, y, z, valid, cfg: GicpConfig):
    """Flat Cartesian voxel id (-1 outside the grid or invalid) and the
    in-grid mask, from scalar coordinate planes."""
    nxy, nz = _grid_dims(cfg)
    div = geometry.div_exact
    ix = torch.floor(div(x + cfg.xy_extent, cfg.voxel_size)).to(torch.int32)
    iy = torch.floor(div(y + cfg.xy_extent, cfg.voxel_size)).to(torch.int32)
    iz = torch.floor(div(z - cfg.z_min, cfg.voxel_size)).to(torch.int32)
    ok = (valid & (ix >= 0) & (ix < nxy) & (iy >= 0) & (iy < nxy)
          & (iz >= 0) & (iz < nz))
    flat = (ix * nxy + iy) * nz + iz
    return torch.where(ok, flat, -1), ok


def voxel_index(xyz: torch.Tensor, valid: torch.Tensor, cfg: GicpConfig):
    """Flat Cartesian voxel id of [N, 3] points; -1 out of bounds/invalid."""
    return _voxel_index_s(xyz[:, 0], xyz[:, 1], xyz[:, 2], valid, cfg)


def build_voxel_map(xyz: torch.Tensor, valid: torch.Tensor,
                    cfg: GicpConfig) -> VoxelMap:
    """Gaussian sums per voxel from one [N, 10] segment sum."""
    nxy, nz = _grid_dims(cfg)
    flat, ok = voxel_index(xyz, valid, cfg)
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    cols = torch.stack([torch.ones_like(x), x, y, z,
                        x * x, y * y, z * z, x * y, x * z, y * z],
                       dim=-1) * ok.to(xyz.dtype)[:, None]
    s = segment_ops.segment_sum(cols, flat, nxy * nxy * nz).T.contiguous()
    n_oob = (valid & ~ok).sum().to(torch.int32)
    return VoxelMap(n=s[0], sum_x=s[1:4], sum_xx=s[4:10], n_oob=n_oob)


def _eig3_lo_hi(c00, c01, c02, c11, c12, c22):
    """Smallest and largest eigenvalues of symmetric 3x3 matrices given as
    six scalar planes (Smith's trigonometric closed form)."""
    q = (c00 + c11 + c22) / 3.0
    b00, b11, b22 = c00 - q, c11 - q, c22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (c01 * c01 + c02 * c02 + c12 * c12))
    iso = p2 <= 1e-18
    p = geometry.sqrt_f32(torch.where(iso, 1.0, p2 / 6.0))
    detB = (b00 * (b11 * b22 - c12 * c12)
            - c01 * (c01 * b22 - c12 * c02)
            + c02 * (c01 * c12 - b11 * c02))
    r = torch.clamp(detB / (2.0 * (p * p * p)), -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e_hi = torch.where(iso, q, q + 2.0 * p * torch.cos(phi))
    e_lo = torch.where(iso, q,
                       q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0))
    return e_lo, e_hi


def _normal_from_cov(c00, c01, c02, c11, c12, c22, lam):
    """Unit eigenvector for eigenvalue `lam` from the largest cross product
    of two rows of (C - lam I). Returns (vx, vy, vz, ok); `ok` is False
    where all three cross products vanish (rank-1 or isotropic covariance),
    and callers zero such voxels' weights."""
    r0 = (c00 - lam, c01, c02)
    r1 = (c01, c11 - lam, c12)
    r2 = (c02, c12, c22 - lam)

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    def norm2(a):
        return a[0] * a[0] + a[1] * a[1] + a[2] * a[2]

    a01, a02, a12 = cross(r0, r1), cross(r0, r2), cross(r1, r2)
    n01, n02, n12 = norm2(a01), norm2(a02), norm2(a12)

    use02 = n02 > n01
    b = [torch.where(use02, u, v) for u, v in zip(a02, a01)]
    bn = torch.maximum(n01, n02)
    use12 = n12 > bn
    b = [torch.where(use12, u, v) for u, v in zip(a12, b)]
    bn = torch.maximum(bn, n12)

    safe = bn > 1e-24
    inv = torch.rsqrt(torch.clamp_min(bn, 1e-30))
    vx = torch.where(safe, b[0] * inv, 0.0)
    vy = torch.where(safe, b[1] * inv, 0.0)
    vz = torch.where(safe, b[2] * inv, 1.0)
    return vx, vy, vz, safe


def finalize_target(vm: VoxelMap, cfg: GicpConfig) -> GicpTarget:
    """Means and regularised inverse covariances per voxel:
    W = (1/a) I + (b / (a (a - b))) n n^T, a = lam_max + delta,
    b = lam_max (1 - eps) (Sherman-Morrison of (C_reg + delta I)^-1,
    gicp.py:186-231). Voxels with no recoverable normal, or a non-finite
    weight, get weight 0."""
    n = torch.clamp_min(vm.n, 1.0)
    mx, my, mz = vm.sum_x[0] / n, vm.sum_x[1] / n, vm.sum_x[2] / n
    c00 = vm.sum_xx[0] / n - mx * mx
    c11 = vm.sum_xx[1] / n - my * my
    c22 = vm.sum_xx[2] / n - mz * mz
    c01 = vm.sum_xx[3] / n - mx * my
    c02 = vm.sum_xx[4] / n - mx * mz
    c12 = vm.sum_xx[5] / n - my * mz

    e_lo, e_hi = _eig3_lo_hi(c00, c01, c02, c11, c12, c22)
    vx, vy, vz, n_ok = _normal_from_cov(c00, c01, c02, c11, c12, c22, e_lo)

    delta = 1e-3
    lam = torch.clamp_min(e_hi, 1e-9)
    a = lam + delta
    b = lam * (1.0 - cfg.plane_eps)
    k = torch.where(n_ok, b / (a * (a - b)), 0.0)
    inv_a = torch.where(n_ok, 1.0 / a, 0.0)
    weight = torch.stack([inv_a + k * vx * vx, inv_a + k * vy * vy,
                          inv_a + k * vz * vz, k * vx * vy, k * vx * vz,
                          k * vy * vz], dim=0)
    weight = torch.where(torch.isfinite(weight).all(0, keepdim=True),
                         weight, 0.0)
    return GicpTarget(mean=torch.stack([mx, my, mz], dim=0), weight=weight,
                      valid=vm.n >= cfg.min_pts_per_voxel)


def _subsample(source_xyz: torch.Tensor, source_valid: torch.Tensor,
               cfg: GicpConfig):
    """The static-stride source subsample; the target keeps full
    density."""
    n = source_xyz.shape[0]
    if cfg.max_source_points and n > cfg.max_source_points:
        stride = -(-n // cfg.max_source_points)
        return source_xyz[::stride], source_valid[::stride]
    return source_xyz, source_valid


def _outer_cap(cfg: GicpConfig) -> int:
    return -(-int(cfg.max_iters) // max(int(cfg.inner_iters), 1))


def _solver(source_xyz, source_valid, tgt_all, tgt_valid, cfg: GicpConfig):
    """(warp, one_pass) for the subsampled source against a target given
    as its [9, G] stack (mean, weight) and valid mask.
    `one_pass(T)` looks up every source point's voxel once, then runs
    `cfg.inner_iters` relinearised steps against those frozen Gaussians; it
    returns (T, err, n_corr, rmse, first), the statistics of the last step
    and `first` the norm of the first step."""
    dtype, device = source_xyz.dtype, source_xyz.device
    sx, sy, sz = source_xyz[:, 0], source_xyz[:, 1], source_xyz[:, 2]
    nxy, nz = _grid_dims(cfg)
    G = nxy * nxy * nz
    inner = max(int(cfg.inner_iters), 1)
    max_d2 = cfg.max_corr_dist ** 2
    h_sign = torch.ones(6, 6, dtype=dtype, device=device)
    h_sign[:3, 3:] = h_sign[3:] = -1.0
    ridge = 1e-6 * torch.eye(6, dtype=dtype, device=device)

    def warp(T):
        R, t = T[:3, :3], T[:3, 3]
        px = R[0, 0] * sx + R[0, 1] * sy + R[0, 2] * sz + t[0]
        py = R[1, 0] * sx + R[1, 1] * sy + R[1, 2] * sz + t[1]
        pz = R[2, 0] * sx + R[2, 1] * sy + R[2, 2] * sz + t[2]
        return px, py, pz

    def gn_step(T, gathered):
        mx, my, mz, w00, w11, w22, w01, w02, w12, okg = gathered
        px, py, pz = warp(T)
        rx, ry, rz = mx - px, my - py, mz - pz
        d2 = rx * rx + ry * ry + rz * rz
        m = (okg & (d2 < max_d2)).to(dtype)

        qx = (w00 * rx + w01 * ry + w02 * rz) * m
        qy = (w01 * rx + w11 * ry + w12 * rz) * m
        qz = (w02 * rx + w12 * ry + w22 * rz) * m

        # M = W [p]x
        M00 = w01 * pz - w02 * py
        M01 = -w00 * pz + w02 * px
        M02 = w00 * py - w01 * px
        M10 = w11 * pz - w12 * py
        M11 = -w01 * pz + w12 * px
        M12 = w01 * py - w11 * px
        M20 = w12 * pz - w22 * py
        M21 = -w02 * pz + w22 * px
        M22 = w02 * py - w12 * px
        # A = [p]x M   (H_rr = [p]x^T W [p]x = -A)
        A00 = -pz * M10 + py * M20
        A01 = -pz * M11 + py * M21
        A02 = -pz * M12 + py * M22
        A11 = pz * M01 - px * M21
        A12 = pz * M02 - px * M22
        A22 = -py * M02 + px * M12

        S = torch.stack([
            w00 * m, w01 * m, w02 * m, w11 * m, w12 * m, w22 * m,
            M00 * m, M01 * m, M02 * m, M10 * m, M11 * m, M12 * m,
            M20 * m, M21 * m, M22 * m,
            A00 * m, A01 * m, A02 * m, A11 * m, A12 * m, A22 * m,
            qx, qy, qz,
            py * qz - pz * qy, pz * qx - px * qz, px * qy - py * qx,
            rx * qx + ry * qy + rz * qz,
            d2 * m, m]).sum(dim=1)
        n_ok = S[29]

        # S's entries picked one by one: an index tensor would be uploaded
        H = torch.stack([S[i] for row in _H_IDX for i in row]).reshape(
            6, 6) * h_sign + ridge
        g = -S[21:27]
        # solve_ex: no host-synchronising error check; a singular H gives
        # non-finite values, which become a zero step
        dxi = -torch.linalg.solve_ex(H, g)[0]
        dxi = torch.where(torch.isfinite(dxi), dxi, 0.0)
        # trust region; no update below 6 correspondences
        tn = torch.linalg.vector_norm(dxi[:3])
        rn = torch.linalg.vector_norm(dxi[3:])
        scale = torch.clamp(torch.minimum(
            cfg.max_step_t / torch.clamp_min(tn, 1e-12),
            cfg.max_step_r / torch.clamp_min(rn, 1e-12)), max=1.0)
        dxi = dxi * scale * (n_ok >= 6).to(dtype)
        sn = torch.clamp_min(n_ok, 1.0)
        stats = (S[27] / sn, n_ok.to(torch.int32),
                 geometry.sqrt_f32(S[28] / sn),
                 torch.linalg.vector_norm(dxi))
        return geometry.exp_se3(dxi) @ T, stats

    def one_pass(T):
        flat, ok = _voxel_index_s(*warp(T), source_valid, cfg)
        f = torch.clamp(flat, 0, G - 1).long()
        gathered = (*tgt_all[:, f], ok & tgt_valid[f])
        for i in range(inner):
            T, (err, ncorr, rmse, step) = gn_step(T, gathered)
            if i == 0:
                # judged on the first step after a re-correspondence: later
                # inner steps converge to the frozen-correspondence fixpoint
                first = step
        return T, err, ncorr, rmse, first

    return warp, one_pass


def _start(T: torch.Tensor):
    """(err, n_corr, rmse) before any pass: inf, 0, inf."""
    inf = torch.full((), math.inf, dtype=T.dtype, device=T.device)
    return inf, torch.zeros((), dtype=torch.int32, device=T.device), inf


def converge_on_host(T, one_pass, cfg: GicpConfig):
    """Outer passes until ceil(max_iters / inner_iters) of them ran or the
    first step of a pass moved no more than `cfg.tolerance`, read on the
    host once per pass. Returns (T, n_iters, err, n_corr, rmse)."""
    err, ncorr, rmse = _start(T)
    it, delta = 0, math.inf
    while it < _outer_cap(cfg) and delta > cfg.tolerance:
        T, err, ncorr, rmse, first = one_pass(T)
        it += 1
        delta = float(first)
    return (T, torch.full((), it, dtype=torch.int32, device=T.device), err,
            ncorr, rmse)


def converge_on_device(T, one_pass, cfg: GicpConfig):
    """`converge_on_host`'s result with no host read: every pass of the cap
    runs, and those after the stop keep the previous values through
    `torch.where`, which is exact."""
    err, ncorr, rmse = _start(T)
    n_iters = torch.zeros((), dtype=torch.int32, device=T.device)
    active = torch.ones((), dtype=torch.bool, device=T.device)
    for _ in range(_outer_cap(cfg)):
        T1, err1, ncorr1, rmse1, first = one_pass(T)
        T = torch.where(active, T1, T)
        err = torch.where(active, err1, err)
        ncorr = torch.where(active, ncorr1, ncorr)
        rmse = torch.where(active, rmse1, rmse)
        n_iters = n_iters + active.to(torch.int32)
        # float(first) > tolerance: a float32 widened to float64 exactly
        active = active & (first.double() > cfg.tolerance)
    return T, n_iters, err, ncorr, rmse


def _solve(source_xyz, source_valid, tgt_all, tgt_valid, T_init,
           cfg: GicpConfig, converge) -> GicpResult:
    """Registration of an already subsampled source; `converge` is one of
    the two drivers of the outer passes."""
    warp, one_pass = _solver(source_xyz, source_valid, tgt_all, tgt_valid,
                             cfg)
    T, n_iters, err, ncorr, rmse = converge(T_init, one_pass, cfg)
    T = geometry.orthonormalize_se3(T)
    _, ok_final = _voxel_index_s(*warp(T), source_valid, cfg)
    n_oob = (source_valid & ~ok_final).sum().to(torch.int32)
    return GicpResult(T=T, n_iters=n_iters, final_error=err, n_corr=ncorr,
                      rmse=rmse, n_oob=n_oob)


class _Graph:
    """`_solve` on a card with `converge_on_device`, captured once into a
    CUDA graph: a call copies its inputs into the static buffers, replays
    the graph and returns clones of the static outputs."""

    def __init__(self, xyz, valid, target: GicpTarget, T_init,
                 cfg: GicpConfig):
        device = xyz.device
        self.xyz = torch.empty(xyz.shape, dtype=xyz.dtype, device=device)
        self.valid = torch.empty(valid.shape, dtype=torch.bool,
                                 device=device)
        G = target.valid.shape[0]
        self.tgt = torch.empty((9, G), dtype=target.mean.dtype,
                               device=device)
        self.tgt_valid = torch.empty((G,), dtype=torch.bool, device=device)
        self.T = torch.empty((4, 4), dtype=T_init.dtype, device=device)
        self.load(xyz, valid, target, T_init)

        def solve():
            return _solve(self.xyz, self.valid, self.tgt, self.tgt_valid,
                          self.T, cfg, converge_on_device)

        # warm up on a side stream first, so that the cuBLAS and cuSOLVER
        # handles and workspaces exist before the capture
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            solve()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = solve()

    def load(self, xyz, valid, target: GicpTarget, T_init) -> None:
        self.xyz.copy_(xyz)
        self.valid.copy_(valid)
        self.tgt[:3].copy_(target.mean)
        self.tgt[3:].copy_(target.weight)
        self.tgt_valid.copy_(target.valid)
        self.T.copy_(T_init)

    def __call__(self, xyz, valid, target: GicpTarget,
                 T_init) -> GicpResult:
        self.load(xyz, valid, target, T_init)
        self.graph.replay()
        return GicpResult(*(t.clone() for t in self.out))


class _Graphs:
    """The captured solves of the process, by device, dtypes, source points
    after the subsample, target voxels, config and the float32 matmul
    precision (read when cuBLAS calls are captured); at most `size`."""

    def __init__(self, size: int):
        self.size = size
        self.graphs = {}

    def solve(self, xyz, valid, target: GicpTarget, T_init,
              cfg: GicpConfig) -> GicpResult:
        key = (xyz.device, xyz.dtype, target.mean.dtype, T_init.dtype,
               xyz.shape[0], target.valid.shape[0], cfg,
               torch.backends.cuda.matmul.allow_tf32)
        g = self.graphs.get(key)
        if g is None:
            if len(self.graphs) >= self.size:
                timing.count("gicp.eager")
                return _solve(xyz, valid, _target_stack(target), target.valid,
                              T_init, cfg, converge_on_device)
            g = self.graphs[key] = _Graph(xyz, valid, target, T_init, cfg)
        timing.count("gicp.graph")
        return g(xyz, valid, target, T_init)


GRAPHS = _Graphs(MAX_GRAPHS)


def _target_stack(target: GicpTarget) -> torch.Tensor:
    return torch.cat([target.mean, target.weight], dim=0)   # [9, G]


def register(source_xyz: torch.Tensor, source_valid: torch.Tensor,
             target: GicpTarget, cfg: GicpConfig,
             T_init: Optional[torch.Tensor] = None) -> GicpResult:
    """Gauss-Newton alignment of a source scan to a voxelized target;
    returns T with target_point ~= T @ source_point (gicp.py:234-402).

    Each outer pass looks up every source point's voxel once, then runs
    `cfg.inner_iters` relinearised steps against those frozen Gaussians.
    The passes stop after ceil(max_iters / inner_iters), or once the first
    step of a pass moved no more than `cfg.tolerance`. On a card the call
    is the replay of one CUDA graph per shape (`GRAPHS`) and reads nothing
    back; elsewhere the stop is read on the host once per pass. Both give
    the same result bit for bit."""
    dtype, device = source_xyz.dtype, source_xyz.device
    if T_init is None:
        T_init = torch.eye(4, dtype=dtype, device=device)
    source_xyz, source_valid = _subsample(source_xyz, source_valid, cfg)
    if device.type == "cuda":
        return GRAPHS.solve(source_xyz, source_valid, target, T_init, cfg)
    timing.count("gicp.eager")
    return _solve(source_xyz, source_valid, _target_stack(target),
                  target.valid, T_init, cfg, converge_on_host)


def pool_voxel_map(vm: VoxelMap, cfg: GicpConfig, factor: int) -> VoxelMap:
    """Downsample a voxel map by `factor` per axis: a coarse voxel is the
    sum of its factor^3 fine children. They are added one after another in
    lexicographic order, as XLA's CPU reduce adds them, so the sums equal
    the JAX package's bit for bit."""
    nxy, nz = _grid_dims(cfg)
    if nxy % factor or nz % factor:
        raise ValueError(f"grid ({nxy},{nz}) not divisible by pyramid "
                         f"factor {factor}")
    cx, cz = nxy // factor, nz // factor

    def pool(a):
        lead = a.shape[:-1]
        k = len(lead)
        a = a.reshape(lead + (cx, factor, cx, factor, cz, factor)).permute(
            *range(k), k, k + 2, k + 4, k + 1, k + 3, k + 5).reshape(
            lead + (cx * cx * cz, factor ** 3))
        out = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
        for j in range(factor ** 3):
            out = out + a[..., j]
        return out

    return VoxelMap(n=pool(vm.n), sum_x=pool(vm.sum_x),
                    sum_xx=pool(vm.sum_xx), n_oob=vm.n_oob)


def _coarse_cfg(cfg: GicpConfig, factor: int) -> GicpConfig:
    return dataclasses.replace(
        cfg, voxel_size=cfg.voxel_size * factor,
        max_corr_dist=cfg.max_corr_dist * factor,
        max_iters=max(cfg.max_iters // 2, 8))


def build_targets(vm: VoxelMap, cfg: GicpConfig):
    """(coarse target or None, its config or None, fine target) of a voxel
    map, finalized once so that several scans can register against them."""
    tgt_c = ccfg = None
    if cfg.coarse_factor > 1:
        ccfg = _coarse_cfg(cfg, cfg.coarse_factor)
        tgt_c = finalize_target(pool_voxel_map(vm, cfg, cfg.coarse_factor),
                                ccfg)
    return tgt_c, ccfg, finalize_target(vm, cfg)


def register_targets(source_xyz: torch.Tensor, source_valid: torch.Tensor,
                     tgt_coarse: Optional[GicpTarget],
                     ccfg: Optional[GicpConfig], tgt_fine: GicpTarget,
                     cfg: GicpConfig,
                     T_init: Optional[torch.Tensor] = None) -> GicpResult:
    """Coarse-to-fine registration against prebuilt targets."""
    if tgt_coarse is not None:
        T_init = register(source_xyz, source_valid, tgt_coarse, ccfg,
                          T_init).T
    return register(source_xyz, source_valid, tgt_fine, cfg, T_init)


def register_pyramid(source_xyz: torch.Tensor, source_valid: torch.Tensor,
                     vm: VoxelMap, cfg: GicpConfig,
                     T_init: Optional[torch.Tensor] = None) -> GicpResult:
    """Coarse-to-fine registration: first against the factor-pooled map,
    then at full resolution from the coarse pose."""
    tgt_c, ccfg, tgt_f = build_targets(vm, cfg)
    return register_targets(source_xyz, source_valid, tgt_c, ccfg, tgt_f,
                            cfg, T_init)


def register_global(source_xyz: torch.Tensor, source_valid: torch.Tensor,
                    vm: VoxelMap, cfg: GicpConfig,
                    n_yaw: int = 16) -> GicpResult:
    """Registration with no motion prior: try `n_yaw` yaw hypotheses on the
    coarse level, keep the one with the most correspondences (tie-broken
    by residual), refine at full resolution."""
    factor = max(cfg.coarse_factor, 2)
    ccfg = _coarse_cfg(cfg, factor)
    tgt_c = finalize_target(pool_voxel_map(vm, cfg, factor), ccfg)
    dtype, device = source_xyz.dtype, source_xyz.device
    yaws = torch.arange(n_yaw, dtype=dtype, device=device) * (
        2 * math.pi / n_yaw)
    one = torch.ones((), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    scores, Ts = [], []
    for yaw in yaws:
        c, s = torch.cos(yaw), torch.sin(yaw)
        Ti = torch.stack([c, -s, zero, zero, s, c, zero, zero,
                          zero, zero, one, zero, zero, zero, zero, one]
                         ).reshape(4, 4)
        res = register(source_xyz, source_valid, tgt_c, ccfg, Ti)
        scores.append(res.n_corr.to(torch.float32) - res.rmse)
        Ts.append(res.T)
    # index_select: indexing with a 0-dim device tensor reads it back
    best = torch.argmax(torch.stack(scores)).reshape(1)
    return register(source_xyz, source_valid, finalize_target(vm, cfg), cfg,
                    T_init=torch.stack(Ts).index_select(0, best)[0])


def scan_to_scan(source_xyz: torch.Tensor, source_valid: torch.Tensor,
                 target_xyz: torch.Tensor, target_valid: torch.Tensor,
                 cfg: GicpConfig,
                 T_init: Optional[torch.Tensor] = None) -> GicpResult:
    vm = build_voxel_map(target_xyz, target_valid, cfg)
    return register_pyramid(source_xyz, source_valid, vm, cfg, T_init)
