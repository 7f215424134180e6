"""The port's dataset I/O, file tools and evaluation helpers against the
JAX package's, on the CPU, on inputs from a numpy seed.

The copied modules (io_kitti, prefetch, io_sydney, logging, config_yaml)
must behave as their originals: files written by one are read identically
by the other, windows and scans are equal arrays, every `configs/*.yaml`
loads to `asdict`-equal configs.

Tolerances: none for integers, masks, labels, colours and file bytes.
Floats:
  * `geometry.pose_to_matrix`, `io_session` poses and accumulated scans:
    1e-6 (float32 sin / cos and one 3 x 3 product in both packages);
  * `nn_distances`: 1e-5 absolute on squared distances of points within
    +-3 m (|a|^2 + |b|^2 - 2 a.b in float32, the product summed in another
    order); the PR / RR / outcome counts built on it are identical because
    no test point sits within that margin of a radius;
  * `occupancy_sweep` rows: PR / RR / F1 equal as floats (integer counts
    divided the same way).
"""

import dataclasses
import json
import logging as std_logging
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu import config_yaml as jconfig_yaml
from dr_using_scv_od_tpu.eval import artifact as jartifact
from dr_using_scv_od_tpu.eval import metrics as jmetrics
from dr_using_scv_od_tpu.eval import sweep as jsweep
from dr_using_scv_od_tpu.models import pipeline as jpipeline
from dr_using_scv_od_tpu.ops import geometry as jgeometry
from dr_using_scv_od_tpu.utils import artifacts as jartifacts
from dr_using_scv_od_tpu.utils import io_kitti as jio_kitti
from dr_using_scv_od_tpu.utils import io_session as jio_session
from dr_using_scv_od_tpu.utils import io_sydney as jio_sydney
from dr_using_scv_od_tpu.utils import logging as jlogging
from dr_using_scv_od_tpu.utils import prefetch as jprefetch
from dr_using_scv_od_tpu.utils import timing as jtiming
from dr_using_scv_od_tpu_torch import config, config_yaml, interop
from dr_using_scv_od_tpu_torch.eval import artifact, metrics, sweep
from dr_using_scv_od_tpu_torch.models import pipeline
from dr_using_scv_od_tpu_torch.ops import geometry
from dr_using_scv_od_tpu_torch.utils import (artifacts, io_kitti, io_session,
                                             io_sydney, logging, prefetch,
                                             synthetic, timing)

ROOT = Path(__file__).resolve().parent.parent
TINY_SPEC = dict(ground_pts=1500, building_pts=300, tree_pts=100,
                 car_pts=120, n_buildings=2, n_trees=3, n_parked_cars=2,
                 n_moving_cars=2, extent=14.0, moving_speed=4.0,
                 ego_speed=1.0, seed=0)


# ------------------------------------------------------------- io_kitti

def _write_sequence(root, rng, n_scans=6, n_pts=500):
    """A KITTI-layout sequence: velodyne/*.bin, labels/*.label (some
    unlabeled points), poses.txt; returns the calibration."""
    (root / "velodyne").mkdir()
    (root / "labels").mkdir()
    for i in range(n_scans):
        pts = rng.normal(size=(n_pts + i, 4)).astype(np.float32)
        pts[:, :3] *= 8
        pts[:, 3] = rng.uniform(0, 1, n_pts + i)
        pts.tofile(root / "velodyne" / f"{i:06d}.bin")
        lab = rng.choice([0, 1, 40, 50, 70, 10, 252], n_pts + i).astype(
            np.uint32) | (rng.integers(0, 50, n_pts + i).astype(np.uint32)
                          << 16)
        lab.tofile(root / "labels" / f"{i:06d}.label")
    poses = np.tile(np.eye(4)[:3].reshape(-1), (n_scans, 1))
    poses[:, 3] = np.arange(n_scans) * 0.7
    poses[:, 7] = rng.normal(size=n_scans)
    np.savetxt(root / "poses.txt", poses)
    tr = np.eye(4)
    tr[:3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]
    tr[:3, 3] = [0.1, -0.2, 0.3]
    return tr


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_io_kitti_files_round_trip_across_packages(tmp_path, rng,
                                                   monkeypatch, native):
    """Each package reads what the other wrote, with the native codec and
    with the numpy decode."""
    if not native:
        monkeypatch.setattr(io_kitti, "_native", lambda: None)
    elif io_kitti._native() is None:
        pytest.skip("native/libio_native.so is not built")
    pts = rng.normal(size=(300, 4)).astype(np.float32)
    pts.tofile(tmp_path / "0.bin")
    lab = rng.integers(0, 2 ** 31, 300).astype(np.uint32)
    lab.tofile(tmp_path / "0.label")
    np.testing.assert_array_equal(io_kitti.read_bin(tmp_path / "0.bin"), pts)
    np.testing.assert_array_equal(io_kitti.read_label(tmp_path / "0.label"),
                                  lab)
    io_kitti.write_pcd_xyzi(tmp_path / "port.pcd", pts)
    jio_kitti.write_pcd_xyzi(tmp_path / "jax.pcd", pts)
    assert (tmp_path / "port.pcd").read_bytes() == \
        (tmp_path / "jax.pcd").read_bytes()
    for reader in (io_kitti.read_pcd_xyzi, jio_kitti.read_pcd_xyzi):
        np.testing.assert_array_equal(reader(tmp_path / "port.pcd"), pts)
    with pytest.raises(FileNotFoundError):
        io_kitti.read_bin(tmp_path / "missing.bin")


def test_sorted_frame_files_and_poses(tmp_path, rng):
    tr = _write_sequence(tmp_path, rng)
    (tmp_path / "velodyne" / "poses.bin").write_bytes(b"")
    got = io_kitti.sorted_frame_files(tmp_path / "velodyne", ".bin")
    assert got == jio_kitti.sorted_frame_files(tmp_path / "velodyne", ".bin")
    assert [p.stem for p in got] == [f"{i:06d}" for i in range(6)]
    a = io_kitti.load_poses(tmp_path / "poses.txt", tr, 1, 6, 2)
    b = jio_kitti.load_poses(tmp_path / "poses.txt", tr, 1, 6, 2)
    assert a.dtype == np.float32 and a.shape == (3, 4, 4)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("labels", [True, False], ids=["labels", "nolabels"])
def test_load_window_equal(tmp_path, rng, labels):
    tr = _write_sequence(tmp_path, rng)
    args = (tmp_path / "velodyne", tmp_path / "labels" if labels else None,
            tmp_path / "poses.txt", tr, 0, 6, 2, 256)
    got = io_kitti.load_window(*args, max_intensity=255.0)
    want = jio_kitti.load_window(*args, max_intensity=255.0)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["xyz"].shape == (3, 256, 3) and got["valid"].any()
    if labels:       # unlabeled points (semantic 0 / 1) were dropped
        assert not np.isin(got["label"][got["valid"]] & 0xFFFF, (0, 1)).any()


@pytest.mark.parametrize("ring", ["native", "python"])
@pytest.mark.parametrize("labels", [True, False], ids=["labels", "nolabels"])
def test_scan_prefetcher_equals_load_scan(tmp_path, rng, monkeypatch, ring,
                                          labels):
    """The prefetcher yields, in file order, what load_scan returns: the
    C++ ring and the Python thread, in both packages."""
    _write_sequence(tmp_path, rng)
    bins = io_kitti.sorted_frame_files(tmp_path / "velodyne", ".bin")
    labs = (io_kitti.sorted_frame_files(tmp_path / "labels", ".label")
            if labels else None)
    if ring == "python":
        monkeypatch.setattr(prefetch.ScanPrefetcher, "_native_with_prefetch",
                            staticmethod(lambda: None))
    pf = prefetch.ScanPrefetcher(bins, labs, max_points=1 << 12, depth=2,
                                 max_intensity=255.0)
    if ring == "native" and not pf.native:
        pytest.skip("native/libio_native.so is not built")
    assert pf.native == (ring == "native")
    got = list(pf)
    want = list(jprefetch.ScanPrefetcher(bins, labs, max_points=1 << 12,
                                         depth=2, max_intensity=255.0))
    assert len(got) == len(want) == len(bins)
    for i, (g, w) in enumerate(zip(got, want)):
        scan = io_kitti.load_scan(bins[i], labs[i] if labs else None, 255.0)
        for a, b, c in zip(g, w, scan):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    with pytest.raises(ValueError):
        prefetch.ScanPrefetcher(bins, [bins[0]])


def test_scan_prefetcher_caps_points_and_reports_errors(tmp_path, rng):
    _write_sequence(tmp_path, rng, n_scans=2)
    bins = io_kitti.sorted_frame_files(tmp_path / "velodyne", ".bin")
    xyz, inten, lab = next(iter(prefetch.ScanPrefetcher(bins, max_points=64)))
    assert xyz.shape == (64, 3) and inten.shape == lab.shape == (64,)
    with pytest.raises((IOError, FileNotFoundError)):
        list(prefetch.ScanPrefetcher([tmp_path / "none.bin"]))


def test_voxel_downsample_equal(rng):
    xyz = rng.normal(size=(2000, 3)).astype(np.float32)
    np.testing.assert_array_equal(io_kitti._voxel_downsample_np(xyz, 0.3),
                                  jio_kitti._voxel_downsample_np(xyz, 0.3))


def test_io_sydney_equal(tmp_path, rng):
    assert io_sydney.SYDNEY_DTYPE == jio_sydney.SYDNEY_DTYPE
    rec = np.zeros(40, dtype=io_sydney.SYDNEY_DTYPE)
    for name in rec.dtype.names:
        rec[name] = rng.integers(0, 100, 40)
    rec.tofile(tmp_path / "obj.bin")
    a, b = (m.read_sydney_bin(tmp_path / "obj.bin")
            for m in (io_sydney, jio_sydney))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(io_sydney.sydney_to_xyzi(tmp_path / "obj.bin"),
                                  jio_sydney.sydney_to_xyzi(tmp_path / "obj.bin"))


def test_run_log_equal(tmp_path):
    rows = {}
    for tag, mod in (("port", logging), ("jax", jlogging)):
        log = mod.RunLog(tmp_path / f"{tag}.jsonl")
        log.event("start", profile="tiny_test")
        log.frame_summary(3, n_clusters=12, n_dynamic=2, ms=41.237)
        log.close()
        rows[tag] = [json.loads(line) for line in
                     (tmp_path / f"{tag}.jsonl").read_text().splitlines()]
        for r in rows[tag]:
            r.pop("t")
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 2
    assert logging.get_logger().name == "dr_using_scv_od_tpu_torch"
    assert isinstance(logging.get_logger(), std_logging.Logger)


# ---------------------------------------------------------- config_yaml

@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.yaml")),
                         ids=lambda p: p.stem)
def test_config_yaml_profiles_equal(path):
    got = config_yaml.load(path)
    assert isinstance(got, config.PipelineConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jconfig_yaml.load(path))
    base, jbase = config.tiny_test(), jconfig.tiny_test()
    assert dataclasses.asdict(config_yaml.load(path, base=base)) == \
        dataclasses.asdict(jconfig_yaml.load(path, base=jbase))


def test_config_yaml_both_key_styles(tmp_path):
    (tmp_path / "p.yaml").write_text(
        "ssc: {occupancy_: 0.35, dynamic_label_: [252, 253], skip_: 2,\n"
        "      car_angle_: 3.0}\n"
        "seg: {search_c: 3}\n"
        "shapes: {max_points: 2048}\n")
    got = config_yaml.load(tmp_path / "p.yaml")
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jconfig_yaml.load(tmp_path / "p.yaml"))
    assert (got.track.occupancy, got.seg.search_c, got.skip,
            got.shapes.max_points, got.dynamic_labels) == (
        0.35, 3, 2, 2048, (252, 253))


# ------------------------------------------------ io_session, geometry

def _write_pose_pcd(path, xyzrpy):
    n = len(xyzrpy)
    with open(path, "wb") as f:
        f.write((f"VERSION 0.7\nFIELDS x y z intensity roll pitch yaw time\n"
                 f"SIZE 4 4 4 4 4 4 4 4\nTYPE F F F F F F F F\n"
                 f"COUNT 1 1 1 1 1 1 1 1\nWIDTH {n}\nHEIGHT 1\nPOINTS {n}\n"
                 "DATA binary\n").encode())
        rows = np.zeros((n, 8), np.float32)
        rows[:, :3] = xyzrpy[:, :3]
        rows[:, 4:7] = xyzrpy[:, 3:]
        f.write(rows.tobytes())


def test_pose_to_matrix_equal(rng):
    xyzrpy = rng.uniform(-3, 3, (5, 7, 6)).astype(np.float32)
    got = geometry.pose_to_matrix(torch.from_numpy(xyzrpy)).numpy()
    want = np.asarray(jgeometry.pose_to_matrix(jnp.asarray(xyzrpy)))
    assert got.shape == (5, 7, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[..., 3, :],
                                  np.broadcast_to([0, 0, 0, 1], (5, 7, 4)))


def test_io_session_equal(tmp_path, rng):
    for i in range(4):
        io_kitti.write_pcd_xyzi(
            tmp_path / f"{i}.pcd",
            rng.normal(size=(150 + 40 * i, 4)).astype(np.float32))
    xyzrpy = rng.uniform(-1, 1, (4, 6)).astype(np.float32)
    _write_pose_pcd(tmp_path / "poses.pcd", xyzrpy)
    a, fa = io_session.read_pcd_fields(tmp_path / "poses.pcd")
    b, fb = jio_session.read_pcd_fields(tmp_path / "poses.pcd")
    assert fa == fb and len(fa) == 8
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(
        io_session.load_pose_cloud(tmp_path / "poses.pcd", device="cpu"),
        jio_session.load_pose_cloud(tmp_path / "poses.pcd"), rtol=0,
        atol=1e-6)
    args = (tmp_path, tmp_path / "poses.pcd", 0, 4, 2, 256)
    got = io_session.load_session_window(*args, device="cpu")
    want = jio_session.load_session_window(*args)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        if k == "poses":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(IOError):
        io_session.load_pose_cloud(tmp_path / "0.pcd", device="cpu")


def test_accumulate_scans_equal(rng):
    scans = [rng.normal(size=(n, 4)).astype(np.float32) for n in (50, 60, 70)]
    poses = [np.asarray(jgeometry.pose_to_matrix(jnp.asarray(
        rng.uniform(-1, 1, 6).astype(np.float32)))) for _ in scans]
    got = io_session.accumulate_scans(scans, poses, center=1, device="cpu")
    want = jio_session.accumulate_scans(scans, poses, center=1)
    assert got.shape == want.shape == (180, 4) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[:, 3], want[:, 3])


# ------------------------------------------------------------ artifacts

def test_artifacts_equal(tmp_path, rng):
    n, C = 400, 12
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    pc = rng.integers(-1, C, n).astype(np.int32)
    typ = rng.integers(-1, 3, C).astype(np.int32)
    state = rng.integers(-1, 2, C).astype(np.int32)
    track = rng.integers(-1, 40, C).astype(np.int32)
    got = artifacts.colored_segmentation(xyz, pc, typ, state, track)
    want = jartifacts.colored_segmentation(xyz, pc, typ, state, track)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (int((pc >= 0).sum()), 6)
    artifacts.write_colored_pcd(tmp_path / "port.pcd", got)
    jartifacts.write_colored_pcd(tmp_path / "jax.pcd", want)
    assert (tmp_path / "port.pcd").read_bytes() == \
        (tmp_path / "jax.pcd").read_bytes()
    labels = rng.choice([40, 50, 252, 253, 259, (7 << 16) | 252], n).astype(
        np.uint32)
    np.testing.assert_array_equal(artifacts.remain_map(xyz, labels),
                                  jartifacts.remain_map(xyz, labels))
    count = rng.integers(0, 3, 64)
    mean = rng.uniform(0, 255, 64).astype(np.float32)
    var = rng.uniform(0, 900, 64).astype(np.float32)
    artifacts.record_intensity(tmp_path / "port", count, mean, var)
    jartifacts.record_intensity(tmp_path / "jax", count, mean, var)
    for suffix in ("_av.txt", "_cov.txt"):
        assert (tmp_path / f"port{suffix}").read_text() == \
            (tmp_path / f"jax{suffix}").read_text() != ""


def test_stage_timer_log_format(tmp_path):
    """time.txt: one tab-separated row of %.2f ms per frame, as the JAX
    package's StageTimer writes it; sync takes nested results."""
    for tag, mod in (("port", timing), ("jax", jtiming)):
        t = mod.StageTimer(tmp_path / tag / "time.txt")
        for _ in range(2):
            with t.stage("a"):
                pass
            with t.stage("b"):
                pass
            t.end_frame()
        t.dump_json(tmp_path / tag / "time.json")
    shapes = []
    for tag in ("port", "jax"):
        rows = (tmp_path / tag / "time.txt").read_text().splitlines()
        shapes.append([[len(c.split(".")[1]) for c in r.split("\t")]
                       for r in rows])
        doc = json.loads((tmp_path / tag / "time.json").read_text())
        assert list(doc["summary"]) == ["a", "b"] and len(doc["rows"]) == 2
    assert shapes[0] == shapes[1] == [[2, 2], [2, 2]]
    timing.sync(None)
    timing.sync({"x": (torch.zeros(2), 3)})


# ----------------------------------------------------- eval: artifact

def test_nn_distances_equal(rng):
    q = rng.uniform(-3, 3, (5000, 3)).astype(np.float32)
    r = rng.uniform(-3, 3, (700, 3)).astype(np.float32)
    got = artifact.nn_distances(q, r, chunk=2048, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (5000,)
    want = np.asarray(jartifact.nn_distances(jnp.asarray(q), jnp.asarray(r),
                                             chunk=2048))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    brute = ((q[:, None, :].astype(np.float64) - r[None]) ** 2).sum(-1).min(1)
    np.testing.assert_allclose(got.numpy(), brute, rtol=0, atol=1e-5)
    assert float(got.min()) >= 0.0


def _maps(rng):
    """A labeled map and estimated static / dynamic clouds whose points sit
    0.03 m from their ground truth or 0.6 m away: far from every radius."""
    n_s, n_d = 600, 200
    gt_xyz = rng.uniform(-3, 3, (n_s + n_d, 3)).astype(np.float32)
    gt_xyz = np.unique(np.round(gt_xyz / 0.6), axis=0).astype(np.float32) * 0.6
    n = len(gt_xyz)
    labels = np.where(np.arange(n) < 0.75 * n, 40, 252).astype(np.uint32)
    labels[::7] |= np.uint32(3 << 16)
    labels[-5:] = 253
    near = gt_xyz + rng.choice([-0.03, 0.03], (n, 3)).astype(np.float32)
    pick = rng.random(n)
    return gt_xyz, labels, near[pick < 0.6], near[(pick >= 0.6) & (pick < 0.9)]


def test_evaluate_maps_equal(rng):
    gt_xyz, labels, est_s, _ = _maps(rng)
    got = artifact.evaluate_maps(gt_xyz, labels, est_s, voxel=0.2,
                                 device="cpu")
    want = jartifact.evaluate_maps(gt_xyz, labels, est_s, voxel=0.2)
    assert got == want
    assert 0 < got["pr"] < 100 and 0 < got["rr"] < 100
    assert set(got["per_class"]) == {252, 253}


def test_four_outcome_map_equal(rng):
    gt_xyz, labels, est_s, est_d = _maps(rng)
    gt_static = ~metrics.is_dynamic_label(labels)
    got = artifact.four_outcome_map(gt_xyz, gt_static, est_s, est_d,
                                    device="cpu")
    want = jartifact.four_outcome_map(gt_xyz, gt_static, est_s, est_d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and all(v > 0 for v in got[2].values())
    empty = np.zeros((0, 3), np.float32)
    a = artifact.four_outcome_map(gt_xyz, gt_static, empty, est_d,
                                  device="cpu")
    b = jartifact.four_outcome_map(gt_xyz, gt_static, empty, est_d)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[2] == b[2] and a[2]["tp"] == 0
    np.testing.assert_array_equal(artifact.OUTCOME_COLORS,
                                  jartifact.OUTCOME_COLORS)


@pytest.mark.parametrize("call", [
    lambda x: artifact.nn_distances(x, x),
    lambda x: artifact.evaluate_maps(x, np.zeros(len(x), np.uint32), x),
    lambda x: artifact.four_outcome_map(x, np.ones(len(x), bool), x, x),
    lambda x: io_session.accumulate_scans([np.zeros((4, 4), np.float32)],
                                          [np.eye(4)], 0),
    lambda x: io_session.load_pose_cloud("poses.pcd"),
    lambda x: io_session.load_session_window(".", "poses.pcd", 0, 1, 1, 8),
], ids=["nn_distances", "evaluate_maps", "four_outcome_map",
        "accumulate_scans", "load_pose_cloud", "load_session_window"])
def test_compute_functions_take_no_default_device(call):
    """No function of the port that computes picks the CPU by itself: the
    caller names the device, as it does for SlamEngine."""
    with pytest.raises(TypeError, match="device"):
        call(np.zeros((4, 3), np.float32))


# ------------------------------------------------------ eval: metrics

def test_per_class_rejection_and_semantic_iou_equal(rng):
    n = 3000
    labels = rng.choice([40, 50, 70, 10, 252, 253, 258, (9 << 16) | 252],
                        n).astype(np.uint32)
    removed = rng.random(n) < 0.4
    valid = rng.random(n) < 0.9
    got = metrics.per_class_rejection(labels, removed, valid)
    assert got == jmetrics.per_class_rejection(labels, removed, valid)
    assert set(got) == {252, 253, 258}
    pred = rng.choice([-1, 40, 50, 70, 10, 252], n).astype(np.int32)
    class_map = {40: (40, 44), 50: (50, 51), 70: (70,), 10: (10, 13),
                 252: tuple(metrics.DYNAMIC_CLASSES)}
    iou = metrics.semantic_iou(labels, pred, valid, class_map)
    assert iou == jmetrics.semantic_iou(labels, pred, valid, class_map)
    assert all(0 < v < 100 for v in iou.values())
    assert metrics.DYNAMIC_CLASSES == jmetrics.DYNAMIC_CLASSES


# ------------------------------------ eval: sweep, the eval-only arguments

@pytest.fixture(scope="module")
def tiny_window():
    cfg = config.tiny_test()
    win = synthetic.render_window(
        synthetic.make_scene(synthetic.SceneSpec(**TINY_SPEC)), 4,
        cfg.shapes.max_points)
    return cfg, jconfig.tiny_test(), win


@pytest.mark.parametrize("compensation", [None, False],
                         ids=["cfg", "no-compensation"])
def test_occupancy_sweep_equal(tiny_window, compensation):
    """The threshold loop of the port against the vmapped JAX sweep:
    `track_window(occupancy=)` over one shared segmentation."""
    cfg, jcfg, win = tiny_window
    thresholds = (0.2, 0.5, 0.8)
    got = sweep.occupancy_sweep(
        *interop.window_from_numpy(win, "cpu"), win["label"], cfg,
        thresholds=thresholds, compensation=compensation)
    want = jsweep.occupancy_sweep(
        *(jnp.asarray(win[k]) for k in ("xyz", "intensity", "valid",
                                        "poses", "label")), jcfg,
        thresholds=thresholds, compensation=compensation)
    assert got == want
    assert [r["threshold"] for r in got] == list(thresholds)
    assert len({(r["pr"], r["rr"]) for r in got}) > 1 or compensation is False
    assert sweep.format_table(got) == jsweep.format_table(want)
    assert sweep.format_table(got).splitlines()[0] == \
        "| threshold | PR | RR | F1 |"


def test_run_window_bbox_dropped_dynamic_equal(tiny_window):
    """The evaluation-only switch also removes the points of clusters that
    the bbox filter erased and routed dynamic."""
    cfg, jcfg, win = tiny_window
    args = interop.window_from_numpy(win, "cpu")
    jargs = tuple(jnp.asarray(win[k]) for k in ("xyz", "intensity", "valid",
                                                "poses"))
    on = pipeline.run_window(*args, cfg, bbox_dropped_dynamic=True)
    off = pipeline.run_window(*args, cfg)
    want = jpipeline.run_window(*jargs, jcfg, bbox_dropped_dynamic=True)
    np.testing.assert_array_equal(on.removed.numpy(),
                                  np.asarray(want.removed))
    routed = on.frames.state.point_route == 5        # ROUTE_BBOX_DYNAMIC
    assert torch.equal(on.removed,
                       off.removed | (routed & args[2]))
