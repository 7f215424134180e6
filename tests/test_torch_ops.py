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


def _sums_in_row_order(x, ids, num):
    """numpy: each id in [0, num) adds its rows in row order, from +0.0."""
    rows = x.reshape(len(x), -1)
    out = np.zeros((num, rows.shape[1]), x.dtype)
    for i, s in enumerate(ids):
        if 0 <= s < num:
            out[s] = out[s] + rows[i]
    return out.reshape((num,) + x.shape[1:])


def _segment_case(case, K, dtype, rng):
    """(x [M] for K == 1, else [M, K]; ids [M] int32; num) of one case."""
    M, num = 300, 40
    ids = rng.integers(-3, num + 3, size=M)
    if case == "all-dropped":
        ids = rng.choice([-7, -1, num, num + 5], size=M)
    elif case == "none-dropped":
        ids = rng.integers(0, num, size=M)
    elif case == "empty-segments":          # every other id has no row
        ids = 2 * rng.integers(0, num // 2, size=M)
    elif case == "single-row-runs":
        ids = rng.permutation(np.r_[np.arange(num), np.full(M - num, -1)])
    elif case == "outside-ids":             # far below 0 and at / above num
        ids = np.where(rng.random(M) < 0.5, ids,
                       rng.choice([-2**31, -1, num, num + 1, 2**31 - 1],
                                  size=M))
    x = rng.normal(size=(M, K)).astype(dtype)
    if case == "negative-zero":             # runs of -0.0 only, and mixed
        x[rng.random(M) < 0.6] = -0.0
        ids = np.where(ids % 3 == 0, ids, num)
        x[ids == 0] = -0.0
    elif case == "order-sensitive":         # in row order 0, reversed 1
        big = 1e8 if dtype == np.float32 else 1e17
        trip = np.array([1.0, big, -big], dtype)
        for s in range(0, num, 4):
            where = np.flatnonzero(ids == s)[:3]
            x[where] = trip[:len(where), None]
    return (x[:, 0] if K == 1 else x), ids.astype(np.int32), num


SEGMENT_CASES = ["random", "all-dropped", "none-dropped", "empty-segments",
                 "single-row-runs", "negative-zero", "order-sensitive",
                 "outside-ids"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("K", [1, 10, 12, 256])
@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_plan_sums_each_run_in_row_order(case, K, dtype):
    """The plan (stable order, sorted ids with the dropped bucket num last)
    and the planned sums against a numpy loop, bit for bit (signed zeros
    included)."""
    rng = np.random.default_rng(SEGMENT_CASES.index(case) * 1000 + K)
    x, ids, num = _segment_case(case, K, dtype, rng)
    order, seg_sorted = segment_ops.segment_plan(_t(ids), num)
    bucket = np.where((ids >= 0) & (ids < num), ids, num)
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(bucket, kind="stable"))
    np.testing.assert_array_equal(seg_sorted.numpy(), np.sort(bucket))
    assert seg_sorted.dtype == order.dtype == torch.int64
    want = _sums_in_row_order(x, ids, num)
    for got in (segment_ops.segment_sum_planned(_t(x), order, seg_sorted,
                                                num),
                segment_ops.segment_sum(_t(x), _t(ids), num)):
        assert got.dtype == _t(x).dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(np.signbit(got.numpy()),
                                      np.signbit(want))


@pytest.mark.parametrize("case", ["random", "outside", "empty",
                                  "one_label"])
def test_grid_label_counts_equal_a_bincount(case):
    """The unweighted histogram, which reads nothing back on a card,
    against numpy's bincount of the labels in [0, num)."""
    rng = np.random.default_rng(7)
    num = 300
    labels = {"random": rng.integers(0, num, 5000),
              "outside": rng.integers(-50, num + 50, 5000),
              "empty": np.zeros(0, np.int64),
              "one_label": np.full(777, 13)}[case]
    got = segment_ops.grid_label_counts(torch.from_numpy(labels).int(), num)
    keep = labels[(labels >= 0) & (labels < num)]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.bincount(keep, minlength=num))


def test_segment_sum_counts_the_plain_path():
    from dr_using_scv_od_tpu_torch.utils import timing
    with timing.recording() as rec:
        s = segment_ops.segment_sum(torch.ones(4, 2),
                                    torch.tensor([0, 1, 1, 5]), 3)
    assert rec.counts == {"segment_sum.plain": 1}
    np.testing.assert_array_equal(s.numpy(), [[1, 1], [2, 2], [0, 0]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", [0, 1])
def test_posegraph_node_sums_keep_their_outputs(seed, dtype):
    """The pose graph's per-node sums through the (order, sorted ids) plan
    equal the lengths-based segment_reduce they were computed with before,
    and the edge-order numpy loop, bit for bit."""
    from dr_using_scv_od_tpu_torch.models import posegraph
    rng = np.random.default_rng(seed)
    F, E = 24, 40
    edge_i = torch.from_numpy(rng.integers(0, F, E).astype(np.int32))
    edge_j = torch.from_numpy(rng.integers(0, F, E).astype(np.int32))
    eye = torch.eye(4, dtype=dtype)
    pg = posegraph.PoseGraph(eye.expand(F, 4, 4), edge_i, edge_j,
                             eye.expand(E, 4, 4), torch.ones(E))
    rows_i = torch.from_numpy(rng.normal(size=(E, 6))).to(dtype)
    rows_j = torch.from_numpy(rng.normal(size=(E, 6))).to(dtype)
    got = posegraph._node_sum(posegraph._node_plan(pg), rows_i, rows_j)

    ids = torch.cat([edge_i, edge_j]).long()
    rows = torch.cat([rows_i, rows_j])
    seg, order = torch.sort(torch.where((ids >= 0) & (ids < F), ids, F),
                            stable=True)
    before = torch.segment_reduce(
        rows[order], "sum", lengths=torch.bincount(seg, minlength=F + 1),
        axis=0, unsafe=True)[:F]
    assert torch.equal(got, before)
    np.testing.assert_array_equal(
        got.numpy(), _sums_in_row_order(rows.numpy(), ids.numpy(), F))


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
