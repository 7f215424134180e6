"""Module parity of the port's ops and per-frame stages against the JAX
package on the same numpy inputs (synthetic scans at the semantickitti()
width, or small random batches).

Tolerances, stated per check:
  * integer and bool outputs: identical;
  * float sums: rtol 1e-5 (the summation order may differ; the voxel
    sums measure bit-identical, since both sum each voxel in point order);
  * eigh3x3: eigenvalues rtol 1e-4 of the largest, eigenvectors 1e-3
    absolute (closed-form acos/cos chains in float32);
  * estimate_ground: the JAX package sums patch moments with a [P, N]
    one-hot matmul, the port with a sequential segment sum, and the float
    rounding differs at the 1e-5 level. On frames 0-2 of the default
    scene the ground masks are identical; on frame 3 36 points of one
    borderline patch flip, and the test bounds that case at 64 points.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu.models import patchwork as jpatchwork
from dr_using_scv_od_tpu.models import recognition as jrecognition
from dr_using_scv_od_tpu.ops import clustering as jclustering
from dr_using_scv_od_tpu.ops import geometry as jgeometry
from dr_using_scv_od_tpu.ops import plane as jplane
from dr_using_scv_od_tpu.ops import quantize as jquantize
from dr_using_scv_od_tpu.ops import segment_ops as jsegment_ops
from dr_using_scv_od_tpu.types import ClusterTable as JClusterTable
from dr_using_scv_od_tpu.utils import synthetic
from dr_using_scv_od_tpu_torch import config
from dr_using_scv_od_tpu_torch.models import patchwork, recognition
from dr_using_scv_od_tpu_torch.ops import (clustering, geometry, plane,
                                           quantize, segment_ops)
from dr_using_scv_od_tpu_torch.types import ClusterTable

CFG = config.semantickitti()
JCFG = jconfig.semantickitti()


@pytest.fixture(scope="module")
def window():
    return synthetic.render_window(synthetic.make_scene(), 5,
                                   CFG.shapes.max_points)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_geometry_matches_jax(window):
    """Elementwise geometry is bit-identical to the JAX functions."""
    xyz = window["xyz"][0]
    for jf, tf in ((jgeometry.range2d, geometry.range2d),
                   (jgeometry.polar_angle_deg, geometry.polar_angle_deg),
                   (jgeometry.azimuth_deg, geometry.azimuth_deg)):
        np.testing.assert_array_equal(tf(_t(xyz)).numpy(),
                                      np.asarray(jf(jnp.asarray(xyz))))


def test_transforms_match_jax():
    """Rigid transforms: float32 products and sums, atol 1e-5 m."""
    rng = np.random.default_rng(2)
    xyzrpy = rng.normal(size=(4, 6)).astype(np.float32)
    T = np.asarray(jgeometry.pose_to_matrix(jnp.asarray(xyzrpy)))
    np.testing.assert_allclose(geometry.inverse_se3(_t(T)).numpy(),
                               np.asarray(jgeometry.inverse_se3(T)),
                               atol=1e-6)
    pts = rng.normal(scale=20.0, size=(1000, 3)).astype(np.float32)
    np.testing.assert_allclose(
        geometry.transform_points(_t(T[0]), _t(pts)).numpy(),
        np.asarray(jgeometry.transform_points(jnp.asarray(T[0]),
                                              jnp.asarray(pts))),
        atol=1e-5)


@pytest.mark.parametrize("frame", [0, 4])
def test_quantize_matches_jax(window, frame):
    xyz, valid = window["xyz"][frame], window["valid"][frame]
    want = jquantize.quantize(jnp.asarray(xyz), jnp.asarray(valid), JCFG.grid)
    got = quantize.quantize(_t(xyz), _t(valid), CFG.grid)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_voxel_stats_moments_matches_jax(window):
    """Against the compiled JAX function, as the pipeline runs it."""
    xyz, valid = window["xyz"][1], window["valid"][1]
    inten = window["intensity"][1]
    _, flat, fov = jquantize.quantize(jnp.asarray(xyz), jnp.asarray(valid),
                                      JCFG.grid)
    jfn = jax.jit(jquantize.voxel_stats_moments, static_argnames=("grid",))
    jg, jm = jfn(flat, jnp.asarray(xyz), jnp.asarray(inten), fov,
                 grid=JCFG.grid)
    tg, tm = quantize.voxel_stats_moments(_t(flat), _t(xyz), _t(inten),
                                          _t(fov), CFG.grid)
    np.testing.assert_array_equal(tg.count.numpy(), np.asarray(jg.count))
    for g, w in ((tg.intensity_mean, jg.intensity_mean),
                 (tg.intensity_var, jg.intensity_var), (tm, jm)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_eigh3x3_matches_jax():
    rng = np.random.default_rng(4)
    B = rng.normal(size=(256, 3, 3)).astype(np.float32)
    A = (B @ np.swapaxes(B, -1, -2)
         + np.diag([0.0, 0.1, 1.0]).astype(np.float32))
    je, jv = jplane.eigh3x3(jnp.asarray(A))
    te, tv = plane.eigh3x3(_t(A))
    scale = np.abs(np.asarray(je)).max(-1, keepdims=True)
    np.testing.assert_allclose(te.numpy() / scale, np.asarray(je) / scale,
                               atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-3)


@pytest.mark.parametrize("frame,max_flips", [(0, 0), (1, 0), (2, 0),
                                             (3, 64)])
def test_estimate_ground_matches_jax(window, frame, max_flips):
    """Masks identical on frames 0-2; frame 3 is the named borderline
    patch (see the module docstring), bounded at `max_flips` points."""
    xyz, valid = window["xyz"][frame], window["valid"][frame]
    jfn = jax.jit(jpatchwork.estimate_ground, static_argnames=("cfg",))
    want = jfn(jnp.asarray(xyz), jnp.asarray(valid), cfg=JCFG.patchwork)
    got = patchwork.estimate_ground(_t(xyz), _t(valid), CFG.patchwork)
    for name in ("ground", "nonground", "dropped"):
        n_diff = int((getattr(got, name).numpy()
                      != np.asarray(getattr(want, name))).sum())
        assert n_diff <= max_flips, f"{name}: {n_diff} points differ"
    np.testing.assert_array_equal(got.dropped.numpy(),
                                  np.asarray(want.dropped))


def test_grid_label_hist_multi_matches_jax():
    rng = np.random.default_rng(5)
    labels = rng.integers(-1, 40, size=20000).astype(np.int32)
    w = rng.integers(0, 300, size=20000).astype(np.int32)
    jc, (jw,) = jsegment_ops.grid_label_hist_multi(
        jnp.asarray(labels), 32, [jnp.asarray(w, jnp.float32)],
        weight_bound=301)
    tc, (tw,) = segment_ops.grid_label_hist_multi(_t(labels), 32, [_t(w)])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(
        segment_ops.grid_label_counts(_t(labels), 32).numpy(),
        np.asarray(jsegment_ops.grid_label_counts(jnp.asarray(labels), 32)))


def test_segment_minmax_matches_jax():
    """Min and max are exact in any order: identical."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(5000, 3)).astype(np.float32)
    ids = rng.integers(-1, 50, size=5000).astype(np.int32)
    valid = rng.random(5000) < 0.9
    jlo, jhi = jsegment_ops.segment_minmax_bcast(
        jnp.asarray(x), jnp.asarray(ids), jnp.asarray(valid), 64)
    tlo, thi = segment_ops.segment_minmax(_t(x), _t(ids), _t(valid), 64)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))


def test_segment_sum_is_sequential_and_drops_outside():
    x = torch.tensor([[1.0], [2.0], [4.0], [8.0]])
    ids = torch.tensor([2, -1, 2, 5])
    np.testing.assert_array_equal(
        segment_ops.segment_sum(x, ids, 3).numpy(), [[0.0], [0.0], [5.0]])


@pytest.mark.parametrize("max_clusters", [512, 8])
def test_compact_grid_labels_matches_jax(max_clusters):
    """Roots numbered in ascending flat-id order; past max_clusters the
    overflowed clusters drop out and their points are counted."""
    shape3 = (6, 16, 64)
    rng = np.random.default_rng(9)
    occ = rng.random(shape3) < 0.05
    roots = np.asarray(jclustering.connected_components(jnp.asarray(occ)))
    G = occ.size
    occ_ids = np.nonzero(occ.reshape(-1))[0]
    flat = np.full(3000, -1, np.int32)
    flat[:2500] = rng.choice(occ_ids, 2500)
    fov = flat >= 0
    want = jclustering.compact_grid_labels(
        jnp.asarray(roots), jnp.asarray(occ.reshape(-1)), jnp.asarray(flat),
        jnp.asarray(fov), max_clusters, G)
    got = clustering.compact_grid_labels(
        _t(roots), _t(occ.reshape(-1)), _t(flat), _t(fov), max_clusters, G)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if max_clusters == 8:
        assert int(got[4]) > 0


def test_recognition_matches_jax(window):
    """Planarity and the decision tree on one frame's voxel moments and a
    random cluster table."""
    xyz, valid = window["xyz"][0], window["valid"][0]
    inten = window["intensity"][0]
    _, flat, fov = quantize.quantize(_t(xyz), _t(valid), CFG.grid)
    grid, mom = quantize.voxel_stats_moments(flat, _t(xyz), _t(inten), fov,
                                             CFG.grid)
    want = jrecognition.voxel_planarity_from_moments(
        jnp.asarray(grid.count.numpy()), jnp.asarray(mom.numpy()), JCFG)
    got = recognition.voxel_planarity_from_moments(grid.count, mom, CFG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    rng = np.random.default_rng(3)
    C = 64
    lo = rng.uniform(-10, 5, size=(C, 3)).astype(np.float32)
    lo[:, 2] = rng.uniform(-2.5, 0.5, size=C)
    hi = lo + rng.uniform(0.1, 9.0, size=(C, 3)).astype(np.float32)
    fields = dict(valid=rng.random(C) < 0.8,
                  n_points=rng.integers(1, 500, C).astype(np.int32),
                  n_voxels=rng.integers(1, 50, C).astype(np.int32),
                  bbox_min=lo, bbox_max=hi,
                  type=np.full(C, -1, np.int32),
                  state=np.full(C, -1, np.int32),
                  track_id=np.full(C, -1, np.int32))
    n_planar = (fields["n_points"] * rng.random(C)).astype(np.float32)
    jt, jf = jrecognition.recognize(
        JClusterTable(**{k: jnp.asarray(v) for k, v in fields.items()}),
        None, jnp.zeros(1, jnp.int32), None, JCFG,
        n_planar=jnp.asarray(n_planar))
    tt, tf = recognition.recognize(
        ClusterTable(**{k: _t(v) for k, v in fields.items()}),
        _t(n_planar), CFG)
    np.testing.assert_array_equal(tt.type.numpy(), np.asarray(jt.type))
    for name in tf._fields:
        np.testing.assert_allclose(getattr(tf, name).numpy(),
                                   np.asarray(getattr(jf, name)),
                                   rtol=1e-6)
