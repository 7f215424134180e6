"""Point clouds on the bin edges of the port's binning functions, for the
card tests (tests/test_torch_cuda.py) and the CPU tests against the JAX
package (tests/test_torch_bin_edges.py). numpy and torch only.

Each cloud places points at every edge of one binning: the coordinate the
function divides (a polar angle, a range, an elevation, a Cartesian
coordinate) is set to each edge's float32 value and to the values
`ULPS` float32 steps either side, at a few radii or angles. The
coordinate the function then computes from x, y, z lies within a few
steps of the edge, and some of the points land on the values where a
correctly rounded division and a product with the divisor's reciprocal
put the point in different bins.
"""

import math

import numpy as np
import torch

ULPS = 2
RADII = (5.3, 11.7, 23.1, 41.9)
ANGLES = (0.31, 1.93, 4.07)


def around(edges) -> np.ndarray:
    """float32 values at each edge and ULPS steps either side."""
    e = np.asarray(edges, np.float64).astype(np.float32)
    out, lo, hi = [e], e, e
    for _ in range(ULPS):
        lo = np.nextafter(lo, np.float32(-np.inf))
        hi = np.nextafter(hi, np.float32(np.inf))
        out += [lo, hi]
    return np.concatenate(out)


def polar(r, theta, z=0.0) -> np.ndarray:
    """[n, 3] float32 points at radius r and angle theta (radians): every
    pair of the two lists, computed in float64."""
    r, theta = np.meshgrid(np.asarray(r, np.float64),
                           np.asarray(theta, np.float64), indexing="ij")
    z = np.broadcast_to(np.asarray(z, np.float64), r.shape)
    return np.stack([r * np.cos(theta), r * np.sin(theta), z],
                    -1).reshape(-1, 3).astype(np.float32)


def quantize_cloud(grid, axis: str) -> np.ndarray:
    """Points on every sector, range or azimuth edge of the curved grid."""
    if axis == "sector":
        deg = around(grid.min_angle + grid.sector_res
                     * np.arange(1, grid.sector_num))
        return polar(RADII, np.deg2rad(deg.astype(np.float64)))
    if axis == "range":
        r = around(grid.min_dis + grid.range_res
                   * np.arange(1, grid.range_num))
        return polar(r, ANGLES)
    el = np.deg2rad(around(grid.min_azimuth + grid.azimuth_res
                           * np.arange(1, grid.azimuth_num))
                    .astype(np.float64))
    r, e, a = np.meshgrid(np.asarray(RADII[:2]), el, np.asarray(ANGLES),
                          indexing="ij")
    return np.stack([r * np.cos(a), r * np.sin(a), r * np.tan(e)],
                    -1).reshape(-1, 3).astype(np.float32)


def patchwork_cloud(pw, axis: str) -> np.ndarray:
    """Points on every ring ("ring") or sector ("sector") edge of
    patchwork's four zones."""
    mrs = pw.min_ranges + (pw.max_range,)
    out = []
    for zone in range(pw.num_zones):
        if axis == "ring":
            r = around(mrs[zone] + pw.ring_sizes[zone]
                       * np.arange(1, pw.num_rings_each_zone[zone]))
            out.append(polar(r, ANGLES))
        else:
            th = around(pw.sector_sizes[zone]
                        * np.arange(1, pw.num_sectors_each_zone[zone]))
            mid = 0.5 * (mrs[zone] + mrs[zone + 1])
            out.append(polar([mid, 0.9 * mid + 0.1 * mrs[zone + 1]],
                             th.astype(np.float64)))
    return np.concatenate(out)


def ring_sector_cloud(min_range, max_range, rings, sectors, axis: str,
                      ego=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Points on every ring or sector edge of a (rings, sectors) polar
    binning between min_range and max_range around `ego` (scan context,
    ERASOR)."""
    span = max_range - min_range
    if axis == "ring":
        pts = polar(around(min_range + span / rings * np.arange(1, rings)),
                    ANGLES)
    else:
        th = around(2 * math.pi / sectors * np.arange(1, sectors))
        pts = polar([min_range + 0.37 * span, min_range + 0.81 * span],
                    th.astype(np.float64))
    return (pts + np.asarray(ego, np.float32)).astype(np.float32)


def voxel_cloud(gicp_cfg) -> np.ndarray:
    """Points on every Cartesian voxel edge of the GICP grid along x, y and
    z (the other two coordinates inside a voxel)."""
    lo = (-gicp_cfg.xy_extent, -gicp_cfg.xy_extent, gicp_cfg.z_min)
    hi = (gicp_cfg.xy_extent, gicp_cfg.xy_extent, gicp_cfg.z_max)
    out = []
    for axis in range(3):
        n = int(round((hi[axis] - lo[axis]) / gicp_cfg.voxel_size))
        v = around(lo[axis] + gicp_cfg.voxel_size * np.arange(1, n))
        pts = np.tile(np.array([3.3, -7.6, 0.45], np.float32), (len(v), 1))
        pts[:, axis] = v
        out.append(pts)
    return np.concatenate(out)


def same_angles(xyz: np.ndarray, device, ego=(0.0, 0.0, 0.0)) -> np.ndarray:
    """[n] bool: the points whose polar angle atan2(y, x) and elevation
    atan2(z, r) (relative to `ego`) come out bit-identical on `device` and
    on the CPU. atan2 rounds its last bit differently on different
    devices; the other steps before a binning's division (sums,
    products, float64 roots) are correctly rounded on both."""
    rel = torch.from_numpy(xyz) - torch.tensor(ego, dtype=torch.float32)

    def angles(t):
        r = torch.sqrt((t[:, 0] * t[:, 0] + t[:, 1] * t[:, 1]).double())
        return (torch.atan2(t[:, 1], t[:, 0]),
                torch.atan2(t[:, 2], r.to(torch.float32)))

    here = angles(rel)
    there = angles(rel.to(device))
    return np.asarray(torch.stack([a == b.cpu() for a, b in
                                   zip(here, there)]).all(0))
