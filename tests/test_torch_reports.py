"""Slice D2's leaf modules against the JAX package's, on the CPU, on inputs
from a numpy seed: eval/reports.py and eval/plots.py (copies),
segment_ops.segment_count / segment_mean, models/features.py,
models/object_map.py and ops/intensity.py. The cases of
tests/test_reports.py, test_intensity_plots.py, test_features.py and
test_utils_aux.py:41 run on both packages.

Tolerances:
  * reports, segment_count, object_map (base_idx, label_grid, the table's
    valid / n_voxels, n_fused), the threefry bits: none (identical);
  * segment_mean: 1e-6 relative (the same order-exact sums; one division);
  * eigen_features: 1e-6 absolute on the seven shape ratios, the point
    count identical. The covariance sums are bit-equal (order-exact
    segment sums); the closed-form eigensolver's trigonometry may round
    differently in PyTorch and XLA (6e-8 measured on these windows);
  * shape_histogram: 1e-6 absolute (identical on these windows; a pairwise
    distance on a bin edge would land in the neighbouring bin if its last
    bit differed);
  * calibrate_by_orientation: 1e-5 relative (2e-6 measured on a tiny_test
    scan: the same moments, normals from the same closed form).
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu.eval import plots as jplots
from dr_using_scv_od_tpu.eval import reports as jreports
from dr_using_scv_od_tpu.models import features as jfeatures
from dr_using_scv_od_tpu.models import object_map as jobject_map
from dr_using_scv_od_tpu.models import pipeline as jpipeline
from dr_using_scv_od_tpu.ops import intensity as jintensity
from dr_using_scv_od_tpu.ops import quantize as jquantize
from dr_using_scv_od_tpu.ops import segment_ops as jsegment_ops
from dr_using_scv_od_tpu.utils import artifacts as jartifacts
from dr_using_scv_od_tpu_torch import config
from dr_using_scv_od_tpu_torch.eval import plots, reports
from dr_using_scv_od_tpu_torch.models import features, object_map
from dr_using_scv_od_tpu_torch.ops import intensity, quantize, segment_ops
from dr_using_scv_od_tpu_torch.types import ClusterTable
from dr_using_scv_od_tpu_torch.utils import synthetic

ROOT = Path(__file__).resolve().parent.parent
REPORTS = {"jax": jreports, "port": reports}
PLOTS = {"jax": jplots, "port": plots}
CFG, JCFG = config.tiny_test(), jconfig.tiny_test()
C = CFG.shapes.max_clusters


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- copies

def _code(path):
    """The module's statements without its docstring."""
    tree = ast.parse(path.read_text())
    tree.body = tree.body[1:]
    return ast.dump(tree)


def test_reports_is_a_copy():
    assert _code(ROOT / "dr_using_scv_od_tpu_torch/eval/reports.py") == \
        _code(ROOT / "dr_using_scv_od_tpu/eval/reports.py")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_intensity_dump_report(tmp_path, pkg):
    rng = np.random.default_rng(0)
    rep = REPORTS[pkg]
    count = np.array([0, 3, 5, 0, 2])
    mean = rng.uniform(0, 30, 5).astype(np.float32)
    var = rng.uniform(0, 100, 5).astype(np.float32)
    jartifacts.record_intensity(tmp_path / "0", count, mean, var)
    av, cov = rep.read_intensity_dump(tmp_path / "0")
    assert len(av) == 3 and len(cov) == 3          # occupied voxels only
    np.testing.assert_allclose(av, mean[count > 0], atol=1e-3)
    np.testing.assert_allclose(cov, var[count > 0] / 100.0, atol=1e-3)
    h = rep.intensity_histogram(av, bins=4)
    assert h["n"] == 3 and h["counts"].sum() == 3
    want = jreports.intensity_histogram(av, bins=4)
    assert h.keys() == want.keys()
    for k in h:
        np.testing.assert_array_equal(h[k], want[k])


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_cluster_feature_matrix_geometry(pkg):
    rng = np.random.default_rng(0)
    rep = REPORTS[pkg]
    plane = np.c_[rng.uniform(-2, 2, (200, 2)),
                  rng.normal(0, 0.01, 200) + 1.0].astype(np.float32)
    line = np.c_[rng.normal(0, 0.01, (150, 2)),
                 rng.uniform(0, 4, 150)].astype(np.float32)
    xyz = np.concatenate([plane, line])
    pc = np.r_[np.zeros(200, np.int32), np.ones(150, np.int32)]
    f = rep.cluster_feature_matrix(xyz, pc, 2)
    np.testing.assert_array_equal(
        f, jreports.cluster_feature_matrix(xyz, pc, 2))
    plane_f = dict(zip(rep.FEATURE_NAMES, f[0]))
    line_f = dict(zip(rep.FEATURE_NAMES, f[1]))
    assert plane_f["planarity"] > 0.7 and plane_f["scattering"] < 0.05
    assert plane_f["orientation"] < 0.1            # normal ~ +z
    assert line_f["linearity"] > 0.9
    assert abs(plane_f["max_height"] - 1.0) < 0.1
    assert line_f["scale"] > 3.5


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_per_class_feature_stats(pkg):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(90, 3)).astype(np.float32)
    pc = np.repeat(np.arange(3, dtype=np.int32), 30)
    ctype = np.array([0, 1, 2], np.int32)          # building, tree, car
    stats = REPORTS[pkg].per_class_feature_stats(xyz, pc, ctype, 3)
    assert set(stats) == {"building", "tree", "car"}
    assert stats["car"]["planarity"]["n"] == 1
    assert stats == jreports.per_class_feature_stats(xyz, pc, ctype, 3)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_parse_time_log_text_and_json(tmp_path, pkg):
    rep = REPORTS[pkg]
    txt = tmp_path / "time.txt"
    txt.write_text("10.0\t20.0\n30.0\t40.0\n")
    res = rep.parse_time_log(txt, ["seg", "track"])
    assert res["summary"] == {"seg": 20.0, "track": 30.0}
    assert res["total_ms"] == 50.0
    js = tmp_path / "time.json"
    js.write_text(json.dumps({"rows": [{"a": 4.0}, {"a": 6.0}],
                              "summary": {}}))
    assert rep.parse_time_log(js)["summary"] == {"a": 5.0}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_plots_write_files(tmp_path, pkg):
    """test_intensity_plots.py's case, plus the two plots the CLI draws;
    both packages return the data they plotted."""
    mod = PLOTS[pkg]
    rows = [{"threshold": t, "pr": 95.0 + t, "rr": 97.0 - t, "f1": 0.95}
            for t in (0.2, 0.5, 0.8)]
    assert mod.plot_pr_rr_sensitivity(rows, tmp_path / "pr.png") is rows
    mod.plot_iou_bars({0: 60.0, 1: 65.0, 2: 96.0},
                      {0: "building", 1: "tree", 2: "car"},
                      tmp_path / "iou.png")
    mod.plot_stage_times({"patchwork": 5.0, "cc": 11.0},
                         tmp_path / "time.png")
    stats = jreports.per_class_feature_stats(
        np.random.default_rng(0).normal(size=(60, 3)).astype(np.float32),
        np.repeat(np.arange(2, dtype=np.int32), 30),
        np.array([0, 2], np.int32), 2)
    mod.plot_feature_box(stats, tmp_path / "feat.png")
    hist = jreports.intensity_histogram(np.arange(20, dtype=np.float32), 4)
    mod.plot_intensity_hist(hist, tmp_path / "hist.png")
    assert mod._HAS_MPL == jplots._HAS_MPL
    if mod._HAS_MPL:
        for name in ("pr", "iou", "time", "feat", "hist"):
            assert (tmp_path / f"{name}.png").stat().st_size > 0


def test_importing_plots_loads_no_matplotlib():
    import subprocess
    import sys
    code = ("import sys, dr_using_scv_od_tpu_torch.eval.plots\n"
            "sys.exit('matplotlib' in sys.modules)")
    assert subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          timeout=120).returncode == 0


# --------------------------------------------------------- segment ops

def test_segment_count_and_mean_equal():
    rng = np.random.default_rng(1)
    n, num = 500, 17
    ids = rng.integers(-3, num + 2, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    for x in (rng.normal(size=n), rng.normal(size=(n, 3))):
        x = x.astype(np.float32)
        got = segment_ops.segment_mean(_t(x), _t(ids), _t(valid), num)
        want = jsegment_ops.segment_mean(jnp.asarray(x), jnp.asarray(ids),
                                         jnp.asarray(valid), num)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    got = segment_ops.segment_count(_t(ids), _t(valid), num)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jsegment_ops.segment_count(jnp.asarray(ids), jnp.asarray(valid),
                                   num)))


# ------------------------------------------------------------ features

@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1])
@pytest.mark.parametrize("n", [1, 7, 600, 4096, 131072])
def test_threefry_uniform_bits_equal_jax(seed, n):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n,)))
    got = features.uniform01(seed, n)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n", [1, 2, 5, 64, 1000])
def test_searchsorted_steps_equal_jax(n):
    """The binary search of shape_histogram gives jnp.searchsorted's answer
    on sorted arrays, on cluster ids followed by an unsorted tail of -1
    (as shape_histogram's), and on arbitrary arrays."""
    rng = np.random.default_rng(n)
    m = rng.integers(0, n + 1)
    head = np.sort(rng.integers(0, 7, m))
    for a in (np.sort(rng.integers(-2, 9, n)),
              np.concatenate([head, np.full(n - m, -1)]),
              rng.integers(-2, 9, n)):
        v = rng.integers(-3, 10, 50)
        want = np.asarray(jnp.searchsorted(jnp.asarray(a), jnp.asarray(v)))
        got = features._searchsorted_left(torch.from_numpy(a),
                                          torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), want)


def _two_clusters(rng):
    """Cluster 0: a thin line (high linearity). Cluster 1: a ball."""
    line = np.stack([np.linspace(0, 5, 300),
                     rng.normal(scale=0.01, size=300),
                     rng.normal(scale=0.01, size=300)], 1)
    ball = rng.normal(scale=1.0, size=(300, 3)) + [10, 0, 0]
    xyz = np.concatenate([line, ball]).astype(np.float32)
    pc = np.concatenate([np.zeros(300), np.ones(300)]).astype(np.int32)
    return xyz, pc


def test_feature_cases_on_the_port():
    """test_features.py's cases on the port, and its JAX results."""
    xyz, pc = _two_clusters(np.random.default_rng(0))
    f = features.eigen_features(_t(xyz), _t(pc), 4, CFG).numpy()
    assert f[0, 0] > 0.95 and f[1, 0] < 0.4 and f[1, 2] > 0.3
    assert f[0, 7] == 300 and f[1, 7] == 300
    h = features.shape_histogram(_t(xyz), _t(pc), 4).numpy()
    assert h.shape == (4, 10)
    np.testing.assert_allclose(h[:2].sum(1), 1.0, atol=1e-5)
    assert np.abs(h[0] - h[1]).sum() > 0.2
    np.testing.assert_allclose(h, np.asarray(jfeatures.shape_histogram(
        jnp.asarray(xyz), jnp.asarray(pc), 4)), atol=1e-6)
    one = torch.ones(10)
    np.testing.assert_allclose(float(features.compare(torch.zeros(10), one)),
                               2.8, atol=1e-6)
    assert float(features.compare(one, one)) == 0.0
    e = np.random.default_rng(1).normal(size=(3, 11)).astype(np.float32)
    s = np.random.default_rng(2).normal(size=(3, 10)).astype(np.float32)
    np.testing.assert_array_equal(
        features.feature21(_t(e), _t(s)).numpy(),
        np.asarray(jfeatures.feature21(jnp.asarray(e), jnp.asarray(s))))
    np.testing.assert_allclose(
        features.compare(_t(e), _t(s)).numpy(),
        np.asarray(jfeatures.compare(jnp.asarray(e), jnp.asarray(s))),
        rtol=1e-6)


@pytest.fixture(scope="module")
def tiny_frames():
    """A tiny_test window (test_utils_aux.py:41's scene) through the JAX
    process_window; the frames' outputs as numpy."""
    spec = synthetic.SceneSpec(ground_pts=1500, building_pts=300,
                               tree_pts=100, car_pts=120, n_buildings=2,
                               n_trees=3, n_parked_cars=2, n_moving_cars=0,
                               extent=14.0, ego_speed=0.5)
    win = synthetic.render_window(synthetic.make_scene(spec), 3,
                                  CFG.shapes.max_points)
    frames = jpipeline.process_window(
        *(jnp.asarray(win[k]) for k in ("xyz", "intensity", "valid",
                                        "poses")), JCFG)
    st = frames.state
    table = {f: np.asarray(getattr(st.clusters, f))
             for f in ("valid", "n_points", "n_voxels", "bbox_min",
                       "bbox_max", "type", "state", "track_id")}
    return win, dict(point_voxel=np.asarray(st.point_voxel),
                     label_grid=np.asarray(st.label_grid),
                     point_cluster=np.asarray(st.point_cluster),
                     table=table), frames


def test_eigen_features_on_window_clusters(tiny_frames):
    win, fr, _ = tiny_frames
    for f in range(3):
        xyz, pc = win["xyz"][f], fr["point_cluster"][f]
        want = np.asarray(jfeatures.eigen_features(
            jnp.asarray(xyz), jnp.asarray(pc), C, JCFG))
        got = features.eigen_features(_t(xyz), _t(pc), C, CFG).numpy()
        assert (pc >= 0).sum() > 0
        np.testing.assert_array_equal(got[:, 7], want[:, 7])
        np.testing.assert_allclose(got[:, :7], want[:, :7], atol=1e-6)


def test_shape_histogram_on_window_clusters(tiny_frames):
    """Most points lie in no cluster here, so the JAX function's binary
    search runs over an unsorted tail; the port takes the same steps."""
    win, fr, _ = tiny_frames
    for f in range(3):
        xyz, pc = win["xyz"][f], fr["point_cluster"][f]
        want = np.asarray(jfeatures.shape_histogram(
            jnp.asarray(xyz), jnp.asarray(pc), C))
        got = features.shape_histogram(_t(xyz), _t(pc), C).numpy()
        live = want.sum(1) > 0
        np.testing.assert_array_equal(got.sum(1) > 0, live)
        np.testing.assert_allclose(got[live].sum(1), 1.0, atol=1e-6)
        np.testing.assert_allclose(got, want, atol=1e-6)


# ----------------------------------------------------------- object map

def test_object_map_initialize_identical(tiny_frames):
    """test_utils_aux.py:41's case on both packages, from the same frame
    outputs: every integer of the result identical."""
    win, fr, frames = tiny_frames
    want = jobject_map.initialize(
        jnp.asarray(win["xyz"]), frames.state.point_voxel,
        jnp.asarray(win["valid"]), frames.state.label_grid,
        frames.state.clusters, jnp.asarray(win["poses"]), JCFG)
    table = ClusterTable(**{k: _t(v) for k, v in fr["table"].items()})
    got = object_map.initialize(
        _t(win["xyz"]), _t(fr["point_voxel"]), _t(win["valid"]),
        _t(fr["label_grid"]), table, _t(win["poses"]), CFG)
    assert int(got.base_idx) == int(want.base_idx)
    assert int(got.n_fused) == int(want.n_fused)
    np.testing.assert_array_equal(got.label_grid.numpy(),
                                  np.asarray(want.label_grid))
    for name in ("valid", "n_voxels", "n_points", "type", "bbox_min"):
        np.testing.assert_array_equal(getattr(got.table, name).numpy(),
                                      np.asarray(getattr(want.table, name)))
    n_cl = fr["table"]["valid"].sum(1)
    assert int(got.base_idx) == len(n_cl) - 1 - int(np.argmin(n_cl[::-1]))
    valid, nvox = got.table.valid.numpy(), got.table.n_voxels.numpy()
    assert np.all(nvox[valid] > 0)
    lg = got.label_grid.numpy()
    assert set(np.unique(lg[lg >= 0])) <= set(np.where(valid)[0])


def test_object_map_fuses_split_clusters():
    """A frame whose one cluster covers two base clusters fuses them into
    the lower row (a hand-made case: the window above fuses nothing or
    little, so the fusion path is pinned here)."""
    rng = np.random.default_rng(3)
    G, N = CFG.grid.bin_num, 64
    xyz = np.zeros((2, N, 3), np.float32)
    xyz[:, :, 0] = rng.uniform(6.0, 6.4, N)
    xyz[:, :, 1] = rng.uniform(-0.4, 0.4, N)
    xyz[:, :, 2] = rng.uniform(-0.5, 0.5, N)
    valid = np.ones((2, N), bool)
    pv = np.asarray(jquantize.quantize(jnp.asarray(xyz[0]),
                                       jnp.asarray(valid[0]),
                                       JCFG.grid)[1])
    grids = np.full((2, G), -1, np.int32)
    vox = np.unique(pv[pv >= 0])
    assert len(vox) >= 2
    grids[0, vox] = np.where(np.arange(len(vox)) < len(vox) // 2, 3, 5)
    grids[1, vox] = 0          # frame 1: one cluster over all of them
    tab = dict(valid=np.zeros((2, C), bool),
               n_points=np.zeros((2, C), np.int32),
               n_voxels=np.zeros((2, C), np.int32),
               bbox_min=np.zeros((2, C, 3), np.float32),
               bbox_max=np.zeros((2, C, 3), np.float32),
               type=np.full((2, C), -1, np.int32),
               state=np.full((2, C), -1, np.int32),
               track_id=np.full((2, C), -1, np.int32))
    tab["valid"][0, [3, 5]] = True
    tab["valid"][1, [0, 1, 2]] = True          # base = frame 0 (fewer)
    pvs = np.stack([pv, pv]).astype(np.int32)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    want = jobject_map.initialize(
        jnp.asarray(xyz), jnp.asarray(pvs), jnp.asarray(valid),
        jnp.asarray(grids), jobject_map.ClusterTable(
            **{k: jnp.asarray(v) for k, v in tab.items()}),
        jnp.asarray(poses), JCFG)
    got = object_map.initialize(
        _t(xyz), _t(pvs), _t(valid), _t(grids),
        ClusterTable(**{k: _t(v) for k, v in tab.items()}), _t(poses), CFG)
    assert int(want.n_fused) == int(got.n_fused) == 1
    np.testing.assert_array_equal(got.label_grid.numpy(),
                                  np.asarray(want.label_grid))
    assert set(np.unique(got.label_grid.numpy())) == {-1, 3}
    np.testing.assert_array_equal(got.table.valid.numpy(),
                                  np.asarray(want.table.valid))


# ------------------------------------------------------------ intensity

def _ground_strip(rng, n, inten, noise=0.01):
    xyz = np.stack([rng.uniform(8, 12, n), rng.uniform(-1, 1, n),
                    np.full(n, -1.7) + rng.normal(scale=noise, size=n)],
                   1).astype(np.float32)
    return xyz, np.full(n, inten, np.float32), np.ones(n, bool)


def _calibrate_both(xyz, inten, valid, grid, jgrid):
    _, flat, fov = jquantize.quantize(jnp.asarray(xyz), jnp.asarray(valid),
                                      jgrid)
    want = np.asarray(jintensity.calibrate_by_orientation(
        jnp.asarray(xyz), jnp.asarray(inten), flat, fov, jgrid))
    _, tflat, tfov = quantize.quantize(_t(xyz), _t(valid), grid)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(flat))
    got = intensity.calibrate_by_orientation(_t(xyz), _t(inten), tflat,
                                             tfov, grid).numpy()
    return got, want, np.asarray(fov)


def test_calibration_cases_on_both_packages():
    """test_intensity_plots.py's two cases: grazing ground brightens, and
    saturation clamps at max_intensity."""
    rng = np.random.default_rng(0)
    got, want, fov = _calibrate_both(*_ground_strip(rng, 400, 50.0),
                                     CFG.grid, JCFG.grid)
    assert got[fov].mean() > 55.0 and got.max() <= 255.0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    got, want, _ = _calibrate_both(*_ground_strip(rng, 100, 250.0, 0.0),
                                   CFG.grid, JCFG.grid)
    assert got.max() <= 255.0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_calibration_on_a_scan(tiny_frames):
    """A whole tiny_test scan, through its curved voxels."""
    win, _, _ = tiny_frames
    xyz, inten, valid = win["xyz"][0], win["intensity"][0], win["valid"][0]
    got, want, _ = _calibrate_both(xyz, inten, valid, CFG.grid, JCFG.grid)
    assert (want != np.minimum(inten, 255.0)).sum() > 100
    np.testing.assert_allclose(got, want, rtol=1e-5)
