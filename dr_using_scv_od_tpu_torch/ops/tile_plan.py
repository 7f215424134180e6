"""The tile plan of the tiled union-find that kernels 1 and 3 run
(csrc/tiled_union_find.cuh, behind ops/cluster_labels.py and
ops/ri3_labels.py).

The [A, R, S] grid is cut into tiles of TA x TR x TS voxels (S innermost;
the last tile of an axis is clipped to the grid). One block runs per tile
in each pass:

  * tile pass: the block holds the tile's occupancy, the intensity planes
    of its occupied voxels and a parent array in shared memory and unites
    every edge whose two ends lie in the tile;
  * seam pass: the block holds the tile plus a halo of `radius` voxels on
    the sides a forward offset can leave it by (+A, both R, both S) and
    unites, in global memory, every edge from a voxel of the tile to a
    voxel outside it;
  * compress (and, for kernel 3, gather): each voxel of an occupied tile.

The plan fixes the tile, the halo and each pass's dynamic shared-memory
bytes, and shrinks the tile until both passes fit the card's 227 KB. The
functions `tile_pass_takes` and `seam_pass_takes` mirror, in PyTorch, the
rule by which each pass takes an edge, so that the tests can check that
the two passes split the edge list of `cluster_labels.union_graph_edges`
exactly.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Tuple

import numpy as np
import torch

SMEM_LIMIT = 232_448          # bytes of shared memory one block may use
SMEM_STATIC = 64              # bytes kept for the kernels' static counters
DEFAULT_TILE = (4, 8, 32)
THREADS = 1024
PAIR_SLOTS = 1024             # csrc/tiled_union_find.cuh kPairSlots
TILES_PER_BLOCK = 8           # csrc/tiled_union_find.cuh kTilesPerBlock


def decoded_offsets(radius: int):
    """The forward offsets as the kernels decode them: offset q is cell
    half + 1 + q of the (2r+1)^3 cube, half its centre's index."""
    w = 2 * radius + 1
    half = (w ** 3 - 1) // 2
    return [(c // (w * w) - radius, (c // w) % w - radius, c % w - radius)
            for c in range(half + 1, w ** 3)]


@dataclasses.dataclass(frozen=True)
class TilePlan:
    grid: Tuple[int, int, int]
    tile: Tuple[int, int, int]
    halo: int                  # the edge radius
    min_label: bool            # kernel 3: a per-tile minimum input label
    threads: int = THREADS

    @property
    def counts(self) -> Tuple[int, int, int]:
        return tuple(-(-g // t) for g, t in zip(self.grid, self.tile))

    @property
    def n_tiles(self) -> int:
        return math.prod(self.counts)

    @property
    def box(self) -> Tuple[int, int, int]:
        """The seam pass's block of voxels: the tile plus its halo."""
        TA, TR, TS = self.tile
        h = self.halo
        return (TA + h, TR + 2 * h, TS + 2 * h)

    @property
    def n_offsets(self) -> int:
        """K, the forward offsets of the edge radius."""
        return ((2 * self.halo + 1) ** 3 - 1) // 2

    @property
    def tile_smem(self) -> int:
        """Tile pass: a 32-bit occupancy mask per row (TA x TR), the offset
        table (K words), per voxel the parent and occupied-list words, the
        minimum input label (kernel 3), mean and variance (radius > 1), and
        one occupancy byte per thread for each of a block's tiles."""
        TA, TR, _ = self.tile
        words = 2 + self.min_label + 2 * (self.halo > 1)
        return (4 * (TA * TR + self.n_offsets)
                + 4 * words * math.prod(self.tile)
                + TILES_PER_BLOCK * self.threads)

    @property
    def seam_smem(self) -> int:
        """Seam pass: the set of united root pairs (PAIR_SLOTS x 8 bytes),
        a 64-bit occupancy mask per box row, the border list (V words), the
        offset table (K words), and per box voxel its tile-pass label and
        (radius > 1) mean and variance."""
        BA, BR, _ = self.box
        per_box = 4 + 8 * (self.halo > 1)
        return (8 * (PAIR_SLOTS + BA * BR)
                + 4 * (math.prod(self.tile) + self.n_offsets)
                + per_box * math.prod(self.box))

    @functools.cached_property
    def kernel_args(self) -> Tuple[int, ...]:
        """(TA, TR, TS, threads, tile_smem, seam_smem), the C entries'
        trailing int arguments (worked out once per plan: the wrappers pass
        them on every call)."""
        return (*self.tile, self.threads, self.tile_smem, self.seam_smem)


@functools.lru_cache(maxsize=None)
def plan(grid: Tuple[int, int, int], radius: int,
         min_label: bool = False) -> TilePlan:
    """The plan for an [A, R, S] grid and edge radius: DEFAULT_TILE clipped
    to the grid, with TS <= 32 (one 32-bit row mask, one lane a voxel),
    TA x TR <= THREADS / 32 (one warp a row) and TS + 2 radius <= 64 (one
    64-bit box-row mask), its largest side halved until both passes fit
    SMEM_LIMIT. Raises where not even a one-voxel tile fits."""
    if min(grid) <= 0 or radius < 1:
        raise ValueError(f"no tile plan for grid {grid}, radius {radius}")
    TA, TR, TS = DEFAULT_TILE
    tile = (min(TA, grid[0]), min(TR, grid[1]),
            min(TS, 32, 64 - 2 * radius, grid[2]))
    if tile[2] < 1:
        raise ValueError(f"radius {radius}: a box row exceeds 64 voxels")
    if tile[0] * tile[1] > THREADS // 32:
        raise ValueError(f"tile {tile}: more rows than a block has warps")
    while True:
        p = TilePlan(tuple(grid), tile, radius, min_label)
        if max(p.tile_smem, p.seam_smem) + SMEM_STATIC <= SMEM_LIMIT:
            return p
        if max(tile) == 1:
            raise ValueError(f"radius {radius}: no tile fits "
                             f"{SMEM_LIMIT} bytes of shared memory")
        i = max(range(3), key=lambda j: tile[j])
        tile = tuple((t + 1) // 2 if j == i else t
                     for j, t in enumerate(tile))


def _coords(grid, flat: torch.Tensor):
    _, R, S = grid
    return flat // (R * S), (flat // S) % R, flat % S


def _local(p: TilePlan, flat: torch.Tensor):
    """(tile origin, local coordinates, clipped tile extent) per voxel."""
    a, r, s = _coords(p.grid, flat)
    out = []
    for x, t, g in zip((a, r, s), p.tile, p.grid):
        origin = (x // t) * t
        out.append((origin, x - origin, torch.clamp(g - origin, max=t)))
    return out


def tile_pass_takes(p: TilePlan, v: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    """The tile pass's rule for the edge from voxel v (flat ids [E]) at
    forward offset d ([E, 3]): the neighbour's local coordinates lie
    inside v's clipped tile."""
    inside = torch.ones_like(v, dtype=torch.bool)
    for (_, x, extent), dx in zip(_local(p, v), d.unbind(1)):
        inside &= (x + dx >= 0) & (x + dx < extent)
    return inside


def seam_pass_takes(p: TilePlan, v: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    """The seam pass's rule: v lies within `halo` of a side that a
    forward offset can leave the tile by (+A, either R, either S), the
    neighbour lies outside v's tile, inside the grid and inside the
    block's box."""
    h = p.halo
    (oa, la, ea), (orr, lr, er), (os_, ls, es) = _local(p, v)
    border = ((la >= ea - h) | (lr < h) | (lr >= er - h) | (ls < h)
              | (ls >= es - h))
    a, r, s = _coords(p.grid, v)
    n = (a + d[:, 0], r + d[:, 1], s + d[:, 2])
    in_grid = torch.ones_like(border)
    for x, g in zip(n, p.grid):
        in_grid &= (x >= 0) & (x < g)
    # box coordinates of the neighbour: tile origin minus the halo on R, S
    box = (n[0] - oa, n[1] - orr + h, n[2] - os_ + h)
    extent = (ea + h, er + 2 * h, es + 2 * h)
    in_box = torch.ones_like(border)
    for x, e in zip(box, extent):
        in_box &= (x >= 0) & (x < e)
    return border & ~tile_pass_takes(p, v, d) & in_grid & in_box


def _snake(dims: Tuple[int, int, int]) -> np.ndarray:
    """One component that winds through the whole [Z, Y, X] box: full
    runs along X on every second row and layer, each joined to the next
    run by one voxel at alternate ends (cheb-1 steps only)."""
    Z, Y, X = dims
    occ = np.zeros(dims, bool)
    rows = []
    for zi, z in enumerate(range(0, Z, 2)):
        ys = list(range(0, Y, 2))
        rows += [(z, y) for y in (ys[::-1] if zi % 2 else ys)]
    for i, (z, y) in enumerate(rows):
        occ[z, y, :] = True
        if i + 1 < len(rows):
            z2, y2 = rows[i + 1]
            occ[(z + z2) // 2, (y + y2) // 2, X - 1 if i % 2 == 0 else 0] = 1
    return occ


def seam_grids(shape3: Tuple[int, int, int], radius: int,
               intensity_cov: float, intensity_diff: float, seed: int = 0):
    """Grids that load the seams of the plan for (shape3, radius), as
    (name, occ [A, R, S] bool, mean [G] f32, var [G] f32) numpy cases:

      * snake-S / snake-R / snake-A: one component winding through every
        tile, its runs along S, R or A; no voxel qualifies, so only the
        cheb-1 steps join it;
      * faces: isolated pairs at Chebyshev 2 (one offset of 1 or 2 across
        the border, the others in -2..2) across every tile border of every
        axis, half of them passing the intensity gate;
      * dense60: 60 % of the voxels occupied at random, random intensities
        around the thresholds (the most contention);
      * corners: one voxel at each corner of every tile (cheb-1 edges across
        tile edges and corners)."""
    A, R, S = shape3
    p = plan(tuple(shape3), radius)
    rng = np.random.default_rng(seed)
    cov, diff = intensity_cov, intensity_diff
    out = []

    def add(name, occ, mean, var):
        out.append((name, occ, mean.astype(np.float32).reshape(-1),
                    var.astype(np.float32).reshape(-1)))

    no_qual = np.full(shape3, 2 * cov + 1, np.float32)
    flat = np.zeros(shape3, np.float32)
    for name, perm in (("snake-S", (0, 1, 2)), ("snake-R", (0, 2, 1)),
                       ("snake-A", (2, 1, 0))):
        dims = tuple(shape3[i] for i in perm)
        add(name, np.ascontiguousarray(
            _snake(dims).transpose(np.argsort(perm))), flat, no_qual)

    occ = np.zeros(shape3, bool)
    mean = rng.uniform(0, 4 * diff, shape3)
    var = np.zeros(shape3, np.float32)
    for axis in range(3):
        for border in range(p.tile[axis], shape3[axis], p.tile[axis]):
            for _ in range(12):
                d = rng.integers(-2, 3, 3)
                d[axis] = rng.integers(1, 3)
                if np.abs(d).max() < 2:
                    d[rng.choice([j for j in range(3) if j != axis])] = (
                        rng.choice([-2, 2]))
                u = np.array([rng.integers(0, n) for n in shape3])
                u[axis] = border - 1
                v = u + d
                if (v < 0).any() or (v >= np.array(shape3)).any():
                    continue
                occ[tuple(u)] = occ[tuple(v)] = True
                passes = rng.random() < 0.5
                mean[tuple(v)] = mean[tuple(u)] + (0.5 if passes else 2) * diff
    add("faces", occ, mean, var)

    add("dense60", rng.random(shape3) < 0.6,
        rng.uniform(0, 6 * diff, shape3), rng.uniform(0, 2 * cov, shape3))

    occ = np.zeros(shape3, bool)
    for axis_starts in itertools.product(
            *(range(0, n, t) for n, t in zip(shape3, p.tile))):
        ends = [min(s0 + t, n) - 1
                for s0, t, n in zip(axis_starts, p.tile, shape3)]
        for corner in itertools.product(*zip(axis_starts, ends)):
            occ[corner] = True
    add("corners", occ, flat, np.zeros(shape3, np.float32))
    return out
