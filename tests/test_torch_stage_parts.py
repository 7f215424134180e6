"""Parity of the stage parts that the stage profiler and the repo's tools
reach (slice F) against the JAX package on the same numpy inputs: the
overflow counters, range3d / matrix_to_euler, segment_min / segment_max /
grid_label_hist2 / weighted grid_label_counts, voxel_stats /
voxel_centers / voxel_downsample, compact_labels / labels_to_grid, the
bounded refine_by_intensity, voxel_planarity and recognize's point-level
fallback. The JAX functions run under jax.jit on the CPU backend.

Tolerances, stated per check:
  * integer and bool outputs (labels, point clusters, overflow counts,
    keep-masks, histograms, planarity, recognition types): identical;
  * range3d: 1e-6 relative (a three-term float32 sum whose order the two
    libraries choose);
  * matrix_to_euler: 2e-6 rad (float32 atan2 and sqrt, last-ulp
    differences);
  * voxel_stats mean / variance: 1e-5 relative and absolute (both sum each
    voxel in point order; the variance is rounded once, as the compiled
    JAX function rounds it);
  * voxel_centers: 2e-5 m absolute (float32 cos / sin / tan at ranges up to
    80 m, where one float32 step is 7.6e-6 m).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu import types as jtypes
from dr_using_scv_od_tpu.models import recognition as jrecognition
from dr_using_scv_od_tpu.models import segmentation as jsegmentation
from dr_using_scv_od_tpu.ops import clustering as jclustering
from dr_using_scv_od_tpu.ops import geometry as jgeometry
from dr_using_scv_od_tpu.ops import quantize as jquantize
from dr_using_scv_od_tpu.ops import segment_ops as jsegment_ops
from dr_using_scv_od_tpu_torch import config, interop, types
from dr_using_scv_od_tpu_torch.models import (patchwork, recognition,
                                              segmentation)
from dr_using_scv_od_tpu_torch.ops import (cluster_labels, clustering,
                                           geometry, quantize, segment_ops)
from dr_using_scv_od_tpu_torch.utils import synthetic

CFG = config.tiny_test()
JCFG = jconfig.tiny_test()
TINY_SCENE = synthetic.SceneSpec(
    ground_pts=1500, building_pts=300, tree_pts=100, car_pts=120,
    n_buildings=2, n_trees=3, n_parked_cars=2, n_moving_cars=2, extent=14.0,
    moving_speed=4.0, ego_speed=1.0, seed=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(a):
    return np.asarray(a)


@pytest.fixture(scope="module")
def frame():
    """Frame 0 of the tiny scene, segmented by the port on the CPU:
    (xyz, intensity, valid, SegmentResult, point_voxel, VoxelGrid)."""
    win = synthetic.render_window(synthetic.make_scene(TINY_SCENE), 1,
                                  CFG.shapes.max_points)
    xyz, inten, valid = (_t(win[k][0]) for k in ("xyz", "intensity",
                                                 "valid"))
    pw = patchwork.estimate_ground(xyz, valid, CFG.patchwork)
    seg, point_voxel, grid = segmentation.segment_frame(
        xyz, inten, pw.nonground, pw.ground, pw.dropped, CFG)
    return xyz, inten, valid, pw, seg, point_voxel, grid


def test_overflow_counters_follow_the_jax_fields():
    got = types.empty_overflow("cpu")
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(jtypes.Overflow)]
    want = jtypes.empty_overflow()
    for name in names:
        v = getattr(got, name)
        assert v.shape == () and v.dtype == torch.int32
        assert int(v) == int(getattr(want, name)) == 0
    assert int(got.replace(points_dropped=_t(np.int32(3))).points_dropped) \
        == 3


def test_range3d_and_matrix_to_euler_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.normal(scale=30.0, size=(2000, 4)).astype(np.float32)
    np.testing.assert_allclose(
        geometry.range3d(_t(pts)).numpy(),
        _n(jax.jit(jgeometry.range3d)(jnp.asarray(pts))), rtol=1e-6)
    rpy = rng.uniform(-3.0, 3.0, size=(500, 3)).astype(np.float32)
    rpy[:8, 1] = np.float32(np.pi / 2)          # the singular branch
    rpy[8:16, 1] = np.float32(-np.pi / 2)
    R = _n(jgeometry.euler_to_matrix(*jnp.asarray(rpy.T)))
    got = geometry.matrix_to_euler(_t(R)).numpy()
    want = _n(jax.jit(jgeometry.matrix_to_euler)(jnp.asarray(R)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    sy = np.hypot(R[:, 0, 0], R[:, 1, 0])
    assert (sy < 1e-6).sum() >= 8                # both branches reached


@pytest.mark.parametrize("shape", [(5000,), (5000, 3)])
def test_segment_min_max_match_jax(shape):
    """Ids past `num` and invalid rows drop out; empty ids give +-inf."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=shape).astype(np.float32)
    ids = rng.integers(-1, 96, size=shape[0]).astype(np.int32)
    ids[(ids >= 70) & (ids < 80)] = 5            # ids 70..79 stay empty
    valid = rng.random(shape[0]) < 0.9
    for tf, jf in ((segment_ops.segment_min, jsegment_ops.segment_min),
                   (segment_ops.segment_max, jsegment_ops.segment_max)):
        want = _n(jax.jit(jf, static_argnums=3)(
            jnp.asarray(x), jnp.asarray(ids), jnp.asarray(valid), 80))
        got = tf(_t(x), _t(ids), _t(valid), 80).numpy()
        np.testing.assert_array_equal(got, want)
        assert np.isinf(got).any()


def test_weighted_histograms_match_jax():
    """grid_label_hist2 and grid_label_counts(weights=): integer-exact
    weight sums, identical counts."""
    rng = np.random.default_rng(3)
    labels = rng.integers(-3, 90, size=30000).astype(np.int32)
    w = rng.integers(0, 4097, size=30000).astype(np.float32)
    jl, jw = jnp.asarray(labels), jnp.asarray(w)
    jsum, jcnt = jax.jit(jsegment_ops.grid_label_hist2,
                         static_argnums=(1, 3))(jl, 80, jw, 4097)
    tsum, tcnt = segment_ops.grid_label_hist2(_t(labels), 80, _t(w))
    np.testing.assert_array_equal(tsum.numpy(), _n(jsum))
    np.testing.assert_array_equal(tcnt.numpy(), _n(jcnt))
    want = _n(jax.jit(lambda l_, w_: jsegment_ops.grid_label_counts(
        l_, 80, weights=w_, weight_bound=4097))(jl, jw))
    got = segment_ops.grid_label_counts(_t(labels), 80, weights=_t(w))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_voxel_stats_matches_jax(frame):
    xyz, inten, _, pw, *_ = frame
    _, flat, fov = quantize.quantize(xyz, pw.nonground, CFG.grid)
    want = jax.jit(jquantize.voxel_stats, static_argnames=("grid",))(
        jnp.asarray(flat.numpy()), jnp.asarray(inten.numpy()),
        jnp.asarray(fov.numpy()), grid=JCFG.grid)
    got = quantize.voxel_stats(flat, inten, fov, CFG.grid)
    np.testing.assert_array_equal(got.count.numpy(), _n(want.count))
    for g, w in ((got.intensity_mean, want.intensity_mean),
                 (got.intensity_var, want.intensity_var)):
        np.testing.assert_allclose(g.numpy(), _n(w), rtol=1e-5, atol=1e-5)
    # the same three sums as the wide [N, 12] scatter of the pipeline
    wide, _ = quantize.voxel_stats_moments(flat, xyz, inten, fov, CFG.grid)
    for name in ("count", "intensity_mean", "intensity_var"):
        assert torch.equal(getattr(got, name), getattr(wide, name)), name


@pytest.mark.parametrize("profile", ["tiny_test", "semantickitti"])
def test_voxel_centers_match_jax(profile):
    grid = getattr(config, profile)().grid
    jgrid = getattr(jconfig, profile)().grid
    want = _n(jax.jit(jquantize.voxel_centers, static_argnums=0)(jgrid))
    got = quantize.voxel_centers(grid, "cpu")
    assert got.shape == (grid.bin_num, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("leaf", [0.08, 0.5])
def test_voxel_downsample_matches_jax(leaf):
    """Points on leaf edges (exact multiples of the leaf, and one float32
    step either side), duplicates, points past the bound, invalid points:
    the keep-masks are identical."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(-30.0, 30.0, size=(6000, 3)).astype(np.float32)
    edges = (rng.integers(-200, 200, size=(3000, 3)) * leaf).astype(
        np.float32)
    nudged = np.nextafter(edges[:1000], np.float32(np.inf))
    pushed = np.nextafter(edges[1000:2000], np.float32(-np.inf))
    far = rng.uniform(-400.0, 400.0, size=(500, 3)).astype(np.float32)
    xyz = np.concatenate([pts, edges, nudged, pushed, pts[:700], far])
    perm = rng.permutation(len(xyz))
    xyz = xyz[perm]
    valid = rng.random(len(xyz)) < 0.85
    fn = jax.jit(jquantize.voxel_downsample, static_argnums=(2, 3))
    want = _n(fn(jnp.asarray(xyz), jnp.asarray(valid), leaf, 200.0))
    got = quantize.voxel_downsample(_t(xyz), _t(valid), leaf)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < valid.sum()


@pytest.mark.parametrize("max_clusters", [512, 8])
def test_compact_labels_and_labels_to_grid_match_jax(max_clusters):
    """Past max_clusters the overflowed clusters drop out of both maps and
    their points are counted; labels_to_grid agrees with
    compact_grid_labels (the same compact ids) below the cap."""
    shape3 = (6, 16, 64)
    rng = np.random.default_rng(9)
    occ = rng.random(shape3) < 0.05
    G = occ.size
    roots = _n(jclustering.connected_components(jnp.asarray(occ)))
    occ_ids = np.nonzero(occ.reshape(-1))[0]
    flat = np.full(3000, -1, np.int32)
    flat[:2500] = rng.choice(occ_ids, 2500)
    fov = flat >= 0
    point_roots = np.where(fov, roots[np.clip(flat, 0, G - 1)], G)

    jfn = jax.jit(jclustering.compact_labels, static_argnums=(2, 3))
    want = jfn(jnp.asarray(point_roots), jnp.asarray(fov), max_clusters, G)
    got = clustering.compact_labels(_t(point_roots), _t(fov), max_clusters,
                                    G)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _n(w))
    occ_flat = occ.reshape(-1)
    want_grid = _n(jax.jit(jclustering.labels_to_grid, static_argnums=3)(
        want[0], jnp.asarray(roots), jnp.asarray(occ_flat), G))
    got_grid = clustering.labels_to_grid(got[0], _t(roots), _t(occ_flat), G)
    np.testing.assert_array_equal(got_grid.numpy(), want_grid)
    if max_clusters == 8:
        assert int(got[3]) > 0 and (want_grid == -1).sum() > (~occ).sum()
    else:
        _, pc2, lg2, _, _ = clustering.compact_grid_labels(
            _t(roots), _t(occ_flat), _t(flat), _t(fov), max_clusters, G)
        assert torch.equal(got_grid, lg2) and torch.equal(got[1], pc2)


def _ri3_grid():
    """A (12, 16, 24) grid (the tiny_test() shape) whose RI3 fixpoint takes
    many rounds: a chain of single voxels two sectors apart (one shell hop
    per round) beside a random, partly gated occupancy."""
    shape3 = CFG.grid.shape
    rng = np.random.default_rng(5)
    occ = rng.random(shape3) < 0.08
    mean = rng.uniform(0.0, 6.0, size=shape3).astype(np.float32)
    var = rng.uniform(0.0, 2.0, size=shape3).astype(np.float32)
    occ[1:6] = False                             # nothing within reach
    occ[3, 4, 0:24:2] = True                     # 12 voxels, 11 hops
    mean[3, 4, :] = 3.0
    var[3, 4, :] = 0.5
    count = np.where(occ, rng.integers(1, 5, size=shape3), 0)
    return occ, count.astype(np.int32), mean, var


@pytest.fixture(scope="module")
def ri3_inputs():
    occ, count, mean, var = _ri3_grid()
    root = _n(jclustering.connected_components(jnp.asarray(occ)))
    jgrid = jtypes.VoxelGrid(count=jnp.asarray(count.reshape(-1)),
                             intensity_mean=jnp.asarray(mean.reshape(-1)),
                             intensity_var=jnp.asarray(var.reshape(-1)))
    grid = types.VoxelGrid(count=_t(count.reshape(-1)),
                           intensity_mean=_t(mean.reshape(-1)),
                           intensity_var=_t(var.reshape(-1)))
    return occ, root, jgrid, grid


def _with_iteration(cfg, k):
    return dataclasses.replace(cfg, seg=dataclasses.replace(cfg.seg,
                                                            iteration=k))


@pytest.mark.parametrize("iteration", [1, 2, 3])
def test_refine_by_intensity_bounded_rounds_match_jax(ri3_inputs, iteration):
    """`iteration` rounds exactly, as the JAX CPU path runs them; short of
    the fixpoint on this grid, so the bound is what is tested."""
    occ, root, jgrid, grid = ri3_inputs
    want = _n(jax.jit(jsegmentation.refine_by_intensity,
                      static_argnames=("cfg",))(
        jnp.asarray(root), jgrid, cfg=_with_iteration(JCFG, iteration)))
    got = segmentation.refine_by_intensity(
        _t(root), grid, _with_iteration(CFG, iteration))
    np.testing.assert_array_equal(got.numpy(), want)
    fix = cluster_labels.cluster_labels_reference(
        _t(occ), grid.intensity_mean, grid.intensity_var,
        CFG.seg.search_c, CFG.seg.intensity_cov, CFG.seg.intensity_diff,
        CFG.seg.far_range_frac)
    assert not torch.equal(got, fix)
    chain = np.ravel_multi_index((3, 4, 0), occ.shape)
    hops = np.ravel_multi_index((3, 4, 2 * (iteration + 1)), occ.shape)
    assert got[hops] != got[chain]


def test_refine_by_intensity_reaches_the_fixpoint(ri3_inputs):
    """At 24 rounds the bounded form equals the union-graph fixpoint of
    the plain kernel version."""
    occ, root, _, grid = ri3_inputs
    got = segmentation.refine_by_intensity(_t(root), grid,
                                           _with_iteration(CFG, 24))
    fix = cluster_labels.cluster_labels_reference(
        _t(occ), grid.intensity_mean, grid.intensity_var,
        CFG.seg.search_c, CFG.seg.intensity_cov, CFG.seg.intensity_diff,
        CFG.seg.far_range_frac)
    assert torch.equal(got, fix)


def test_voxel_planarity_matches_jax(frame):
    xyz, _, _, _, seg, point_voxel, grid = frame
    in_fov = seg.point_cluster >= 0
    want = _n(jax.jit(jrecognition.voxel_planarity,
                      static_argnames=("cfg",))(
        jnp.asarray(xyz.numpy()), jnp.asarray(point_voxel.numpy()),
        jnp.asarray(in_fov.numpy()), cfg=JCFG))
    got = recognition.voxel_planarity(xyz, point_voxel, in_fov, CFG)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()
    # on the voxels the histograms consume, the segmentation stage's
    # planarity (from its moment sums) is the same decision
    used = seg.label_grid >= 0
    assert torch.equal(got[used], seg.planar_vox[used])


@pytest.mark.parametrize("branch", ["grid", "points"])
def test_recognize_fallback_matches_jax(frame, branch):
    """Both branches of recognize's point-level fallback: the weighted
    label-grid histogram and the per-point count. Identical types."""
    xyz, _, _, _, seg, point_voxel, grid = frame
    t = seg.clusters
    jtable = jtypes.ClusterTable(**{
        f.name: jnp.asarray(getattr(t, f.name).numpy())
        for f in dataclasses.fields(t)})
    extra = {}
    if branch == "grid":
        extra = dict(label_grid=seg.label_grid, voxel_count=grid.count)
    jfn = jax.jit(jrecognition.recognize, static_argnames=("cfg",))
    jt, jf = jfn(jtable, jnp.asarray(xyz.numpy()),
                 jnp.asarray(seg.point_cluster.numpy()),
                 jnp.asarray(point_voxel.numpy()), cfg=JCFG,
                 **{k: jnp.asarray(v.numpy()) for k, v in extra.items()})
    tt, tf = recognition.recognize_points(t, xyz, seg.point_cluster,
                                          point_voxel, CFG, **extra)
    np.testing.assert_array_equal(tt.type.numpy(), _n(jt.type))
    np.testing.assert_array_equal(tf.planar_ratio.numpy(),
                                  _n(jf.planar_ratio))
    assert (tt.type.numpy() >= 0).sum() >= 2


def test_recognize_fallback_equals_the_pipeline_path(frame):
    """With the segmentation stage's planar voxels, the fallback gives the
    types of the pipeline's recognize(table, n_planar)."""
    xyz, _, _, _, seg, point_voxel, grid = frame
    want, _ = recognition.recognize(seg.clusters, seg.n_planar, CFG)
    got, _ = recognition.recognize_points(
        seg.clusters, xyz, seg.point_cluster, point_voxel, CFG,
        label_grid=seg.label_grid, voxel_count=grid.count,
        planar_vox=seg.planar_vox)
    assert torch.equal(got.type, want.type)
