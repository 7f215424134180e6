"""Cluster feature descriptors and comparison (counterpart of
dr_using_scv_od_tpu/models/features.py; see its docstring for the
reference API it covers: getDescriptorByEigenValue, the ESF replacement
and compareFeature, src/ssc.cpp:658-911).

`shape_histogram` samples each cluster in an order drawn from
`jax.random.uniform(jax.random.PRNGKey(seed), (N,))`. The port computes the
same float32 numbers without JAX: `uniform01` is the threefry2x32 block
cipher in numpy over the counters 0..N-1, in the layout JAX uses when
`jax_threefry_partitionable` is on (the default since JAX 0.5), with the
32-bit words `bits1 ^ bits2` mapped to [0, 1) through the mantissa.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import PipelineConfig
from ..ops import geometry, plane as plane_ops, segment_ops

# compareFeature weights (src/ssc.cpp:900-909)
_COMPARE_W = (0.5, 0.5, 0.2, 0.2, 0.2, 0.2, 0.2, 0.6, 0.2, 0.0)

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple, x0: np.ndarray, x1: np.ndarray):
    """The 20-round threefry2x32 block of (x0, x1) uint32 counters under the
    uint32 key pair (Salmon et al., SC'11; the form of jax._src.prng)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3]) + np.uint32(i + 1)
    return x0, x1


def uniform01(seed: int, n: int) -> np.ndarray:
    """[n] float32 in [0, 1): `jax.random.uniform(PRNGKey(seed), (n,))`
    for a non-negative 32-bit seed (key words (0, seed))."""
    counter = np.arange(n, dtype=np.uint64)
    hi = (counter >> np.uint64(32)).astype(np.uint32)
    lo = (counter & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32((0, seed & 0xFFFFFFFF), hi, lo)
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    return np.maximum(bits.view(np.float32) - np.float32(1.0),
                      np.float32(0.0))


def eigen_features(xyz: torch.Tensor, point_cluster: torch.Tensor,
                   n_clusters: int, cfg: PipelineConfig) -> torch.Tensor:
    """[C, 8] real eigenvalue geometry per cluster: linearity, planarity,
    scattering, omnivariance, anisotropy, eigen-entropy, curvature change,
    point count (the commented-out formulas at src/ssc.cpp:688-721)."""
    C = n_clusters
    valid = point_cluster >= 0
    mean = segment_ops.segment_mean(xyz, point_cluster, valid, C)
    n = segment_ops.segment_count(point_cluster, valid, C)

    d = xyz - mean[torch.clamp(point_cluster, 0, C - 1).long()]
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    ids = torch.where(valid, point_cluster, -1)
    s = segment_ops.segment_sum(
        torch.stack([x * x, x * y, x * z, y * y, y * z, z * z], -1), ids, C)
    sxx, sxy, sxz, syy, syz, szz = s.unbind(-1)

    nf = torch.clamp_min(n, 1).to(torch.float32)
    cov = torch.stack([
        torch.stack([sxx, sxy, sxz], -1),
        torch.stack([sxy, syy, syz], -1),
        torch.stack([sxz, syz, szz], -1),
    ], dim=-2) / nf[:, None, None]
    evals, _ = plane_ops.eigh3x3(cov)
    # descending e1 >= e2 >= e3, normalized
    e = torch.flip(torch.clamp_min(evals, 1e-12), dims=(-1,))
    e = e / e.sum(-1, keepdim=True)
    e1, e2, e3 = e[:, 0], e[:, 1], e[:, 2]

    linearity = ((e1 - e2) / e1).abs()
    planarity = ((e2 - e3) / e1).abs()
    scattering = (e3 / e1).abs()
    omnivariance = ((e1 * e2 * e3) ** (1.0 / 3.0)).abs()
    anisotropy = ((e1 - e3) / e1).abs()
    entropy = -(e * torch.log(e)).sum(-1)
    curvature = e3 / torch.clamp_min(e1 + e2 + e3, 1e-12)
    return torch.stack([linearity, planarity, scattering, omnivariance,
                        anisotropy, entropy, curvature,
                        n.to(torch.float32)], dim=-1)


def _searchsorted_left(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """`jnp.searchsorted(a, v)` step for step: ceil(log2(len + 1)) halvings
    of [0, len) with `v <= a[mid]` sending the search left. On a sorted `a`
    this is the usual left insertion point; `shape_histogram` also queries
    one whose tail is unsorted (the -1 of the points in no cluster), where
    the answer is what these steps give."""
    low = torch.zeros_like(v, dtype=torch.int64)
    high = torch.full_like(low, a.shape[0])
    for _ in range(int(np.ceil(np.log2(a.shape[0] + 1)))):
        mid = (low + high) // 2
        left = v <= a[mid]
        low, high = torch.where(left, low, mid), torch.where(left, mid, high)
    return high


def shape_histogram(xyz: torch.Tensor, point_cluster: torch.Tensor,
                    n_clusters: int, n_samples: int = 128,
                    n_bins: int = 10, seed: int = 0) -> torch.Tensor:
    """[C, n_bins] D2 shape-distribution histogram per cluster: pairwise
    distances between a fixed pseudo-random point sample, normalized by the
    cluster's max sample distance (src/ssc.cpp:770-779's ESF, replaced).

    The sample is the JAX function's: points ranked within their cluster by
    the same noise, the rank found by its binary search, the slots written
    as its scatter writes them (a negative slot counts from the end, one
    past the end is dropped, the last of equal slots wins)."""
    C = n_clusters
    N = xyz.shape[0]
    device = xyz.device
    valid = point_cluster >= 0

    noise = torch.from_numpy(uniform01(seed, N)).to(device)
    key = torch.where(valid, point_cluster * 2.0 + noise,
                      torch.tensor(1e9, dtype=torch.float32, device=device))
    order = torch.argsort(key, stable=True)
    pc_sorted = point_cluster[order].long()
    rank = torch.arange(N, device=device) - _searchsorted_left(pc_sorted,
                                                               pc_sorted)
    sel = (rank < n_samples) & (pc_sorted >= 0)
    size = C * n_samples + 1
    slot = torch.where(sel, pc_sorted * n_samples + rank, C * n_samples)
    slot = torch.where(slot < 0, slot + size, slot)
    kept = (slot >= 0) & (slot < size)
    writer = torch.arange(N, device=device)
    last = torch.full((size,), -1, dtype=torch.int64, device=device)
    last = last.scatter_reduce(0, slot[kept], writer[kept], "amax")
    wrote = last >= 0
    src = torch.clamp_min(last, 0)
    samples = torch.where(wrote[:, None] & sel[src][:, None],
                          xyz[order][src], 0.0)
    has = wrote & sel[src]
    S = samples[:-1].reshape(C, n_samples, 3)
    H = has[:-1].reshape(C, n_samples)

    diff = S[:, :, None, :] - S[:, None, :, :]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
          + diff[..., 2] * diff[..., 2])
    pair_ok = H[:, :, None] & H[:, None, :]
    d = geometry.sqrt_f32(torch.clamp_min(d2, 0.0))
    dmax = torch.where(pair_ok, d, 0.0).amax(dim=(1, 2))
    dn = d / torch.clamp_min(dmax, 1e-6)[:, None, None]
    bins = torch.clamp((dn * n_bins).to(torch.int64), 0, n_bins - 1)
    flat = torch.where(pair_ok, bins + n_bins * torch.arange(
        C, device=device)[:, None, None], C * n_bins)
    hist = torch.bincount(flat.reshape(-1), minlength=C * n_bins + 1)
    hist = hist[:-1].reshape(C, n_bins).to(torch.float32)
    return hist / torch.clamp_min(hist.sum(-1, keepdim=True), 1.0)


def feature21(eigen11: torch.Tensor, shape10: torch.Tensor) -> torch.Tensor:
    """Concat to the reference's 21-dim descriptor (getFeature21,
    src/ssc.cpp:788-795)."""
    return torch.cat([eigen11, shape10], dim=-1)


def compare(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """Weighted L1 over the first 10 slots (compareFeature,
    src/ssc.cpp:897-911). Batched: [..., >=10] x [..., >=10] -> [...]."""
    w = torch.tensor(_COMPARE_W, dtype=f1.dtype, device=f1.device)
    return ((f1[..., :10] - f2[..., :10]).abs() * w).sum(-1)
