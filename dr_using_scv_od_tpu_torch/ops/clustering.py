"""Connected components on the curved-voxel grid and compaction to the
cluster table (counterpart of dr_using_scv_od_tpu/ops/clustering.py).

The plain versions here work on an explicit edge list between occupied
voxels: `occupied_pairs` enumerates each voxel's forward neighbours,
and `min_label_components` runs min-label propagation with pointer jumping
to the exact fixpoint. Nothing wraps: not the sector axis (the reference
clamps at sector 0 / sector_num-1, src/ssc.cpp:402-403), not the azimuth
or the range axis.
"""

from __future__ import annotations

import itertools
from typing import List, Tuple

import torch


def forward_offsets(radius: int) -> List[Tuple[int, int, int]]:
    """The (da, dr, ds) offsets of Chebyshev distance 1..radius that are
    lexicographically positive: one of each +-d pair, so every undirected
    edge is enumerated once. 13 at radius 1, 62 at radius 2."""
    rng = range(-radius, radius + 1)
    return [d for d in itertools.product(rng, rng, rng)
            if d > (0, 0, 0)]


def occupied_pairs(occupied3: torch.Tensor,
                   offsets: List[Tuple[int, int, int]]):
    """Neighbour pairs between occupied voxels.

    Returns (ids [M] int64 ascending flat ids of the occupied voxels,
    nbr [M, K] int64 flat id of the neighbour at each offset (0 where out
    of bounds), ok [M, K] bool: neighbour in bounds and occupied)."""
    A, R, S = occupied3.shape
    occ = occupied3.reshape(-1)
    ids = torch.nonzero(occ).squeeze(1)
    a, r, s = ids // (R * S), (ids // S) % R, ids % S
    off = torch.tensor(offsets, dtype=torch.int64,
                       device=occ.device).reshape(-1, 3)
    na = a[:, None] + off[:, 0]
    nr = r[:, None] + off[:, 1]
    ns = s[:, None] + off[:, 2]
    inb = ((na >= 0) & (na < A) & (nr >= 0) & (nr < R)
           & (ns >= 0) & (ns < S))
    nbr = torch.where(inb, (na * R + nr) * S + ns, 0)
    return ids, nbr, inb & occ[nbr]


def min_label_components(n_voxels: int, ids: torch.Tensor,
                         src: torch.Tensor, dst: torch.Tensor,
                         init: torch.Tensor | None = None) -> torch.Tensor:
    """Exact connected components of the graph on the voxels `ids`
    (ascending flat ids) with undirected edges (src[e], dst[e]) (flat ids).

    Min-label propagation (`scatter_reduce` amin both ways over the edge
    list) plus pointer jumping `lab = lab[lab]`, until nothing changes.
    Returns [n_voxels] int32: each listed voxel holds the minimum flat id
    of its component, every other voxel its own id. With `init` ([n_voxels]
    integer labels), each listed voxel holds instead the minimum of `init`
    over its component: the fixpoint of min-label propagation seeded with
    `init`. Raises if the iteration guard (one more round than there are
    voxels; the labels converge within the graph's diameter) is
    exceeded."""
    device = ids.device
    M = ids.numel()
    cs = torch.searchsorted(ids, src)
    cd = torch.searchsorted(ids, dst)
    lab = torch.arange(M, device=device)
    for _ in range(M + 2):
        m = lab.scatter_reduce(0, cs, lab[cd], "amin")
        m = m.scatter_reduce(0, cd, lab[cs], "amin")
        m = m[m]
        if torch.equal(m, lab):
            break
        lab = m
    else:
        raise RuntimeError("min-label propagation did not converge")
    out = torch.arange(n_voxels, dtype=torch.int32, device=device)
    if init is None:
        out[ids] = ids[lab].to(torch.int32)
    else:
        seed = init[ids].long()
        comp_min = torch.full_like(seed, torch.iinfo(torch.int64).max
                                   ).scatter_reduce(0, lab, seed, "amin")
        out[ids] = comp_min[lab].to(torch.int32)
    return out


def connected_components(occupied: torch.Tensor) -> torch.Tensor:
    """26-connected components of [A, R, S] occupancy: [G] int32, each
    occupied voxel holds its component's minimum flat id, each empty voxel
    its own id (the contract of clustering.py:69-119)."""
    ids, nbr, ok = occupied_pairs(occupied, forward_offsets(1))
    src = ids[:, None].expand_as(nbr)[ok]
    return min_label_components(occupied.numel(), ids, src, nbr[ok])


def compact_grid_labels(root_grid: torch.Tensor, occupied: torch.Tensor,
                        flat_voxel: torch.Tensor, in_fov: torch.Tensor,
                        max_clusters: int, sentinel: int):
    """Number the component roots in ascending flat-id order and map voxels
    and points to compact cluster ids (clustering.py:142-198).

    Root voxels (occupied, root_grid[g] == g) get the exclusive prefix
    count of roots as their id; a voxel's id is its root's. Clusters past
    `max_clusters` are dropped, and their in-FOV points are counted.

    Returns (roots [C] int32 padded with `sentinel`,
             point_cluster [N] int32 (-1 invalid/overflowed),
             label_grid [G] int32 (-1 empty/overflowed),
             n_clusters scalar int32, n_dropped_points scalar int32)."""
    C = max_clusters
    G = root_grid.shape[0]
    device = root_grid.device
    g_iota = torch.arange(G, dtype=root_grid.dtype, device=device)
    is_root = occupied & (root_grid == g_iota)
    cum = torch.cumsum(is_root.to(torch.int32), 0, dtype=torch.int32)
    n_roots = cum[-1]
    n_clusters = torch.clamp(n_roots, max=C)

    c_iota = torch.arange(C, dtype=torch.int32, device=device)
    roots = torch.searchsorted(cum, c_iota + 1, side="left").to(torch.int32)
    roots = torch.where(c_iota < n_roots, roots, sentinel)

    rank = cum[root_grid.long()] - 1
    label_grid = torch.where(occupied & (rank < C), rank, -1
                             ).to(torch.int32)

    safe_flat = torch.clamp(flat_voxel, 0, G - 1).long()
    point_cluster = torch.where(in_fov, label_grid[safe_flat], -1)
    n_dropped = torch.sum(in_fov & (point_cluster < 0)).to(torch.int32)
    return roots, point_cluster, label_grid, n_clusters, n_dropped


def compact_labels(point_roots: torch.Tensor, point_valid: torch.Tensor,
                   max_clusters: int, sentinel: int):
    """Compact cluster ids [0, C) from per-point root labels by a sorted
    unique (clustering.py:201-225): the C smallest distinct roots of the
    valid points, in ascending order.

    Returns (roots [C] int32 padded with `sentinel`,
             point_cluster [N] int32 (-1 invalid or past the cap),
             n_clusters scalar int32,
             n_dropped_points scalar int32: valid points whose cluster fell
             beyond the cap)."""
    C = max_clusters
    keys = torch.where(point_valid, point_roots, sentinel)
    uniq = torch.unique(keys)[:C]
    roots = torch.full((C,), sentinel, dtype=torch.int32,
                       device=keys.device)
    roots[:uniq.numel()] = uniq.to(torch.int32)
    pos = torch.clamp(torch.searchsorted(roots, keys.to(torch.int32)), 0,
                      C - 1)
    hit = (roots[pos] == keys) & point_valid
    point_cluster = torch.where(hit, pos, -1).to(torch.int32)
    n_clusters = (roots != sentinel).sum().to(torch.int32)
    n_dropped = (point_valid & ~hit).sum().to(torch.int32)
    return roots, point_cluster, n_clusters, n_dropped


def labels_to_grid(roots: torch.Tensor, root_grid: torch.Tensor,
                   occ: torch.Tensor, sentinel: int) -> torch.Tensor:
    """[G] int32 compact-cluster-id grid from per-voxel root labels and the
    sorted `roots` of `compact_labels`; empty voxels and voxels of dropped
    clusters get -1 (clustering.py:228-238)."""
    keys = torch.where(occ, root_grid, sentinel).to(roots.dtype)
    pos = torch.clamp(torch.searchsorted(roots, keys), 0,
                      roots.shape[0] - 1)
    hit = (roots[pos] == keys) & occ
    return torch.where(hit, pos, -1).to(torch.int32)
