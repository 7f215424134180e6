"""`cli slam --data`'s scan stream (`cli.stream_scans`) on the CPU at
tiny_test() sizes, against the plain reference reader of the benchmark
(`benchmark/reference/scan_stream.py`): the padded scans are the
reference's bit for bit on both prefetch tiers (the C++ ring and the
Python thread) and on both down-sample paths (the host's numpy and
`quantize.first_point_per_leaf` in torch), with points planted on 0.08 m
leaf edges and several points to a leaf; `first_point_per_leaf` keeps the
host's points bit for bit, points far out, infinite and NaN among them;
an engine session fed from the stream is the session fed from the
reference's scans; inside `timing.recording()` each scan is one
`scan_read` and one `downsample` span and the `scan.*` counts are the
points decoded and kept and the path each scan took; a stream closed
half-read leaves no reader running."""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest
import torch

from benchmark.reference import scan_stream
from dr_using_scv_od_tpu_torch import cli, config
from dr_using_scv_od_tpu_torch.models import engine
from dr_using_scv_od_tpu_torch.ops import quantize
from dr_using_scv_od_tpu_torch.utils import (io_kitti, prefetch, synthetic,
                                             timing)

CFG = config.tiny_test()        # 4,096 points a scan, every 5th file
EC = engine.EngineConfig(window=4, max_keyframes=16, submap_points=256,
                         kf_dist=0.5, loop_min_gap=4, loop_min_score=0.5,
                         max_loop_edges=8, pgo_gn_iters=2, pgo_cg_iters=8,
                         erasor_every=2)
LEAF = 0.08
CPU = torch.device("cpu")


def _reference(directory, cfg=CFG, start=0, end=0):
    return scan_stream.read_sequence(
        directory, start, end, cfg.skip, cfg.max_intensity, LEAF,
        4 * cfg.shapes.max_points, cfg.shapes.max_points)


def _write(directory, scans, skip):
    """KITTI layout: scan k is file k * skip; the files between are hard
    links to the scan before them."""
    directory.mkdir(parents=True, exist_ok=True)
    for k, pts in enumerate(scans):
        first = directory / f"{k * skip:06d}.bin"
        np.ascontiguousarray(pts, np.float32).tofile(first)
        for j in range(1, skip):
            os.link(first, directory / f"{k * skip + j:06d}.bin")


def _edge_scan(rng, n):
    """n points with a third of them on 0.08 m leaf edges (k * 0.08 in
    float32 and the floats either side), and every point repeated in its
    leaf a few times in shuffled order, reflectance in [0, 1]."""
    k = rng.integers(-300, 300, size=(n // 3, 3)).astype(np.float32)
    edge = k * np.float32(LEAF)
    edge = np.where(rng.random(edge.shape) < 0.3,
                    np.nextafter(edge, np.float32(np.inf)), edge)
    edge = np.where(rng.random(edge.shape) < 0.3,
                    np.nextafter(edge, np.float32(-np.inf)), edge)
    free = rng.uniform(-24, 24, size=(n - len(edge), 3)).astype(np.float32)
    xyz = np.concatenate([edge, free])
    near = xyz[rng.integers(0, len(xyz), size=n // 2)] + rng.uniform(
        -0.03, 0.03, size=(n // 2, 3)).astype(np.float32)
    xyz = np.concatenate([xyz, near])
    xyz = xyz[rng.permutation(len(xyz))]
    refl = rng.uniform(0, 1, size=(len(xyz), 1)).astype(np.float32)
    return np.concatenate([xyz, refl], 1)


@pytest.fixture
def edge_dir(tmp_path, rng):
    """Four scans: three under the 4,096-point padding once down-sampled,
    one whose kept points overflow it."""
    scans = [_edge_scan(rng, n) for n in (600, 1500, 2400, 6000)]
    d = tmp_path / "sequences" / "00" / "velodyne"
    _write(d, scans, CFG.skip)
    return d


def _python_tier(monkeypatch):
    monkeypatch.setattr(prefetch.ScanPrefetcher, "_native_with_prefetch",
                        staticmethod(lambda: None))


def _native_or_skip():
    lib = prefetch.ScanPrefetcher._native_with_prefetch()
    if lib is None:
        pytest.skip("native/libio_native.so is not built")
    return lib


def _leaf_path(device):
    """The count of the down-sample path `stream_scans` takes on `device`."""
    on_card = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    return "scan.leaf_card" if on_card else "scan.leaf_host"


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("tier", ["native", "python"])
def test_the_stream_is_the_reference_bit_for_bit(edge_dir, monkeypatch,
                                                 tier, device):
    if tier == "python":
        _python_tier(monkeypatch)
    else:
        _native_or_skip()
    want = _reference(edge_dir)
    scans, n = cli.stream_scans(edge_dir, CFG, device=device)
    got = list(scans)
    assert n == len(got) == len(want) == 4
    kept = [int(v.sum()) for _, _, v in want]
    assert kept[-1] == CFG.shapes.max_points       # the cut at N is tested
    assert all(0 < k < CFG.shapes.max_points for k in kept[:-1])
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    # start / end pick the same files on both sides
    part, m = cli.stream_scans(edge_dir, CFG, start=5, end=16,
                               device=device)
    want = _reference(edge_dir, start=5, end=16)
    assert m == len(want) == 3
    for g, w in zip(part, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def _padded(xyz, inten, keep, n_out):
    X = np.zeros((n_out, 3), np.float32)
    I = np.zeros((n_out,), np.float32)
    V = np.zeros((n_out,), bool)
    n = min(int(keep.sum()), n_out)
    X[:n], I[:n], V[:n] = xyz[keep][:n], inten[keep][:n], True
    return X, I, V


@pytest.mark.parametrize("n_out", [4096, 1024])
def test_first_point_per_leaf_keeps_the_hosts_points(rng, n_out):
    """On the edge scan's points, with points at +-1e6 m, +-inf and NaN
    mixed in: the torch form keeps the points the host's numpy mask keeps
    (and the reference's), pads them as the stream does, and cuts them at
    n_out (1,024 cuts, 4,096 does not)."""
    pts = _edge_scan(rng, 2400)
    odd = np.array([[1e6, -1e6, 0.0], [-1e6, 1e6, 1e6], [np.inf, 0, 0],
                    [-np.inf, 0, 0], [0, np.inf, -np.inf], [np.nan, 0, 0],
                    [0, 0, np.nan], [np.nan, np.nan, np.nan],
                    [1e30, 0, 0], [-1e30, 0, 0]], np.float32)
    odd = np.concatenate([odd, odd + np.float32(0.01)])
    xyz = np.concatenate([pts[:, :3], odd])
    perm = rng.permutation(len(xyz))
    xyz = np.ascontiguousarray(xyz[perm])
    inten = rng.uniform(0, 255, size=len(xyz)).astype(np.float32)
    with np.errstate(invalid="ignore"):
        keep = io_kitti._voxel_downsample_np(xyz, LEAF)
        np.testing.assert_array_equal(
            scan_stream.first_per_leaf(xyz, LEAF), keep)
        want_ijk = np.floor(xyz / np.float32(LEAF)).astype(np.int64)
    np.testing.assert_array_equal(
        quantize.leaf_index(torch.from_numpy(xyz), LEAF).numpy(), want_ijk)
    assert (keep.sum() > n_out) == (n_out == 1024)
    got = quantize.first_point_per_leaf(torch.from_numpy(xyz),
                                        torch.from_numpy(inten), LEAF, n_out)
    for a, b in zip(got, _padded(xyz, inten, keep, n_out)):
        assert a.numpy().dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy().view(np.uint8),
                                      b.view(np.uint8))


def test_the_reference_keeps_the_first_point_of_a_leaf():
    xyz = np.array([[0.01, 0.01, 0.01], [0.02, 0.02, 0.02],
                    [0.09, 0.0, 0.0], [0.05, 0.05, 0.05],
                    [0.08, 0.0, 0.0]], np.float32)
    np.testing.assert_array_equal(scan_stream.first_per_leaf(xyz, LEAF),
                                  [True, False, True, False, False])


def _tiny_loop_scans(frames):
    spec = synthetic.SceneSpec(
        ground_pts=1500, building_pts=300, tree_pts=100, car_pts=120,
        n_buildings=2, n_trees=3, n_parked_cars=2, n_moving_cars=2,
        extent=14.0, moving_speed=4.0, trajectory="loop", loop_frames=8,
        loop_radius=8.0, seed=3)
    scene = synthetic.make_scene(spec)
    out = []
    for f in range(frames):
        xyz, inten, _, _ = synthetic.render_frame(scene, f)
        refl = np.clip(inten / np.float32(255.0), 0, 1)
        out.append(np.concatenate([xyz, refl[:, None]], 1))
    return out


def _session(scans):
    eng = engine.SlamEngine(CFG, EC, materialize_outputs=True, device=CPU)
    windows = []
    for scan in scans:
        out = eng.feed(*scan)
        if out is not None:
            windows.append(out)
    eng.finalize(final_erasor=True)
    return windows, eng.poses(), eng.kf_frames(), int(eng.state.n_loops)


def test_an_engine_session_fed_from_the_stream_is_the_references(tmp_path):
    d = tmp_path / "velodyne"
    _write(d, _tiny_loop_scans(10), CFG.skip)
    scans, n = cli.stream_scans(d, CFG)
    assert n == 10
    got, want = _session(scans), _session(_reference(d))
    assert len(got[0]) == len(want[0]) == 3
    for a, b in zip(got[0], want[0]):
        for field in ("poses", "removed", "is_kf", "loop_pair",
                      "loop_accepted"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3]


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("tier", ["native", "python"])
def test_each_scan_is_one_read_and_one_downsample_span(edge_dir,
                                                       monkeypatch, tier,
                                                       device):
    if tier == "python":
        _python_tier(monkeypatch)
    else:
        _native_or_skip()
    with timing.recording() as rec:
        scans, n = cli.stream_scans(edge_dir, CFG, device=device)
        got = list(scans)
    names = [s.name for s in rec.spans]
    assert names == ["scan_read", "downsample"] * n
    assert all(s.depth == 0 and s.end_ns >= s.start_ns for s in rec.spans)
    files = scan_stream.frame_files(edge_dir)[::CFG.skip]
    read = sum(min(f.stat().st_size // 16, 4 * CFG.shapes.max_points)
               for f in files)
    assert dict(rec.counts) == {
        f"scan.{tier}": n, _leaf_path(device): n, "scan.points_read": read,
        "scan.points_kept": sum(int(v.sum()) for _, _, v in got)}
    # outside a recording the stream records nothing and yields the same
    again, _ = cli.stream_scans(edge_dir, CFG, device=device)
    for g, w in zip(again, got):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def _readers(before):
    return [t for t in threading.enumerate()
            if t not in before and t.is_alive()]


@pytest.mark.parametrize("tier", ["native", "python"])
def test_a_stream_closed_half_read_leaves_no_reader(tmp_path, rng,
                                                    monkeypatch, tier):
    closed = []
    if tier == "python":
        _python_tier(monkeypatch)
    else:
        lib = _native_or_skip()

        class Spy:
            def __getattr__(self, name):
                return getattr(lib, name)

            def prefetch_close(self, h):
                closed.append(h)
                lib.prefetch_close(h)

        spy = Spy()
        monkeypatch.setattr(prefetch.ScanPrefetcher, "_native_with_prefetch",
                            staticmethod(lambda: spy))
    d = tmp_path / "velodyne"
    _write(d, [_edge_scan(rng, 600) for _ in range(12)], CFG.skip)
    before = set(threading.enumerate())
    scans, n = cli.stream_scans(d, CFG)
    assert n == 12
    next(scans)
    next(scans)
    scans.close()
    assert _readers(before) == []
    if tier == "native":
        assert len(closed) == 1      # prefetch_close joined its worker
