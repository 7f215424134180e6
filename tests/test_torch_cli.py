"""The port's command line against the JAX package's, in process, on the
same arguments (`tiny_test` profile, the port with `--device cpu`; the
synthetic scenes come from a numpy seed, the file tools' inputs from
`np.random.default_rng`).

Tolerances:
  * integers, masks, label-derived percentages and written PCD point sets:
    none. The printed PR / RR / F1 / IoU lines and the file tools' lines
    are compared as strings, that is to the digits printed;
  * odometry poses, ATE and per-pair error: 5e-4 absolute on pose entries
    and ATE (two float32 GICP solvers that sum in different orders; the
    packages agree to ~1e-6 on these windows), 1e-3 relative on the
    per-pair residual;
  * slam on the `--data` path (5 scans of the tiny scene, down-sampled at
    0.08 m as the CLI does; two engine windows with an ERASOR pass): every
    pose within 5e-4 of the jitted JAX CLI's (3.8e-5 measured), every
    counter identical, `erasor_removed` included, and the map's point count
    within 0.1 %. This is the fast tier's 5e-4 hold of the engine through
    the entry point;
  * slam on the synthetic 8-frame run (three windows), ATE and map: the
    first two poses within 5e-4, the rest within 5e-2 m, the JAX package's
    own spread on this run. The tiny profile's 4,096-point scans leave
    scan-to-map GICP ~600 correspondences on near-singular voxel
    covariances (the ill-conditioned case of tests/test_torch_engine.py,
    here from the third pose on): the JAX CLI jitted and the same CLI under
    `jax.disable_jit()` differ by 3.7e-3 m at the third pose and 3.4e-2 m
    at the last, while the port agrees with the eager JAX run to 1.8e-4
    (held at 5e-4 by the slow-tier test below; the eager run takes over
    3 min whatever the number of frames). Counters are identical except
    `erasor_removed`, which follows the poses (within 10 %; 1038 against
    1052), as does the number of map points (within 1 %). A resumed run of
    the port equals its uninterrupted run within 1e-5;
  * `time.txt` holds wall-clock times: only its shape is compared.
"""

import contextlib
import io
import re

import numpy as np
import pytest

from dr_using_scv_od_tpu import cli as jcli
from dr_using_scv_od_tpu_torch import cli, config
from dr_using_scv_od_tpu_torch.utils import (io_kitti, io_session, io_sydney,
                                             synthetic)

POSE_ATOL = 5e-4
TINY = ["--profile", "tiny_test", "--scene", "tiny"]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([str(a) for a in argv])
    assert rc == 0
    return buf.getvalue().splitlines()


def _both(argv, device=True, swap=None):
    """(JAX CLI's lines, port's lines). `swap` maps a path of the JAX run
    to the port's (output directories differ)."""
    jax_lines = _run(jcli.main, argv)
    port_argv = [swap.get(a, a) if swap else a for a in argv]
    if device:
        port_argv = port_argv[:1] + ["--device", "cpu"] + port_argv[1:]
    return jax_lines, _run(cli.main, port_argv)


def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.?\d*(?:e-?\d+)?", line)]


def _same_pcds(dir_a, dir_b, pattern):
    names = sorted(p.name for p in dir_a.glob(pattern))
    assert names and names == sorted(p.name for p in dir_b.glob(pattern))
    for name in names:
        a, fa = io_session.read_pcd_fields(dir_a / name)
        b, fb = io_session.read_pcd_fields(dir_b / name)
        assert fa == fb
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=name)
    return names


# ---------------------------------------------------------------- segdf

@pytest.fixture(scope="module")
def segdf_runs(tmp_path_factory):
    ja, po = (tmp_path_factory.mktemp(n) for n in ("segdf_jax", "segdf_port"))
    argv = ["segdf", *TINY, "--frames", 4, "--iou", "--out", str(ja)]
    jl, pl = _both(argv, swap={str(ja): str(po)})
    return ja, po, jl, pl


def test_segdf_prints_the_same_metrics(segdf_runs):
    """PR / RR / F1, the per-class table and the five IoU lines, to the
    digits printed."""
    _, _, jl, pl = segdf_runs
    assert jl[:-1] == pl[:-1]
    assert jl[0].startswith("frames=4  PR=") and "judged frames" in jl[0]
    assert sum(line.startswith("  IoU ") for line in pl) == 5
    assert jl[-1].startswith("artifacts -> ") and \
        pl[-1].startswith("artifacts -> ")


def test_segdf_writes_the_same_artifacts(segdf_runs):
    """Per frame the static, dynamic and coloured PCDs hold identical
    points (bit for bit), and time.txt one row with one stage."""
    ja, po, _, _ = segdf_runs
    for pattern in ("*_static.pcd", "*_dynamic.pcd", "*_seg.pcd"):
        assert len(_same_pcds(ja, po, pattern)) == 4
    for d in (ja, po):
        rows = (d / "time.txt").read_text().splitlines()
        assert len(rows) == 1 and len(rows[0].split("\t")) == 1


def test_segdf_pcds_split_the_valid_points(segdf_runs):
    """static + dynamic = the valid points of each frame."""
    _, po, _, _ = segdf_runs
    cfg = config.tiny_test()
    spec = synthetic.SceneSpec(
        ground_pts=1500, building_pts=300, tree_pts=100, car_pts=120,
        n_buildings=2, n_trees=3, n_parked_cars=2, n_moving_cars=2,
        extent=14.0, moving_speed=4.0, ego_speed=1.0, seed=0)
    win = synthetic.render_window(synthetic.make_scene(spec), 4,
                                  cfg.shapes.max_points)
    for f in range(4):
        n = sum(len(io_kitti.read_pcd_xyzi(po / f"{f:06d}_{kind}.pcd"))
                for kind in ("static", "dynamic"))
        assert n == int(win["valid"][f].sum())


def test_segdf_estimate_poses_runs_on_the_port(tmp_path):
    """`--estimate-poses` adds the odometry stage to time.txt."""
    lines = _run(cli.main, ["segdf", "--device", "cpu", *TINY, "--frames", 3,
                            "--estimate-poses", "--out", tmp_path])
    assert lines[0].startswith("frames=3  PR=")
    rows = (tmp_path / "time.txt").read_text().splitlines()
    assert len(rows) == 1 and len(rows[0].split("\t")) == 2


def test_default_device_raises_without_a_card(tmp_path):
    """The default device is the card: with none visible every computing
    subcommand raises instead of carrying on on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is visible")
    io_kitti.write_pcd_xyzi(tmp_path / "a.pcd", np.zeros((4, 4), np.float32))
    a = str(tmp_path / "a.pcd")
    for argv in (["segdf", *TINY, "--frames", "2"],
                 ["odometry", *TINY, "--frames", "2"],
                 ["slam", *TINY, "--frames", "4", "--window", "4"],
                 ["bench-table", *TINY, "--frames", "2"],
                 ["evaluate", "--gt", a, "--est", a],
                 ["evaluate-map", "--gt", a, "--static", a, "--dynamic", a,
                  "--out", str(tmp_path / "e.pcd")],
                 ["erasor", "--map", a, "--scan", a]):
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            cli.main(argv)


# ------------------------------------------------------------- odometry

def test_odometry_matches(tmp_path):
    ja, po = tmp_path / "jax.txt", tmp_path / "port.txt"
    jl, pl = _both(["odometry", *TINY, "--frames", 3, "--out", str(ja)],
                   swap={str(ja): str(po)})
    assert len(jl) == len(pl) == 4
    (fj, ate_j), (fp, ate_p) = _numbers(jl[0]), _numbers(pl[0])
    assert fj == fp == 3 and abs(ate_j - ate_p) <= POSE_ATOL
    for a, b in zip(jl[1:3], pl[1:3]):
        na, nb = _numbers(a), _numbers(b)
        assert na[:3] == nb[:3]                      # pair ids, corr count
        assert abs(na[3] - nb[3]) <= 1e-3 * abs(na[3])
    np.testing.assert_allclose(np.loadtxt(po), np.loadtxt(ja), rtol=0,
                               atol=POSE_ATOL)


# ----------------------------------------------------------------- slam

SLAM = ["slam", *TINY, "--frames", 8, "--window", 4]
PORT_SLAM = SLAM[:1] + ["--device", "cpu"] + SLAM[1:]
SPREAD_ATOL = 5e-2     # the JAX package's own jitted-vs-eager spread here
RESUME_ATOL = 1e-5     # a resumed run against the uninterrupted one


def _summary(lines):
    """(integer counters of the `frames=...` line as a dict, ATE or
    None)."""
    head = next(line for line in lines if line.startswith("frames="))
    ate = [float(line.split("=")[1].split()[0]) for line in lines
           if line.startswith("ATE=")]
    return ({k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", head)},
            ate[0] if ate else None)


def _same_summary(a, b, exact=False):
    """Equal counters; erasor_removed, which follows the poses, within
    10 % (equal where `exact`); ATE within the spread."""
    (ca, ate_a), (cb, ate_b) = _summary(a), _summary(b)
    ea, eb = ca.pop("erasor_removed"), cb.pop("erasor_removed")
    assert ca == cb
    assert abs(ea - eb) <= (0 if exact else 0.10 * max(ea, eb))
    assert (ate_a is None) == (ate_b is None)
    if ate_a is not None:
        assert abs(ate_a - ate_b) <= SPREAD_ATOL
    return ca


def _same_outputs(ja, po, atol=SPREAD_ATOL, map_rtol=0.01):
    tj = np.loadtxt(ja / "trajectory.txt")
    tp = np.loadtxt(po / "trajectory.txt")
    assert tj.shape == tp.shape
    np.testing.assert_allclose(tp[:2], tj[:2], rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(tp, tj, rtol=0, atol=atol)
    nj = len(io_kitti.read_pcd_xyzi(ja / "map_static.pcd"))
    n_port = len(io_kitti.read_pcd_xyzi(po / "map_static.pcd"))
    assert abs(nj - n_port) <= map_rtol * nj
    return tj


@pytest.fixture(scope="module")
def slam_runs(tmp_path_factory):
    ja, po = (tmp_path_factory.mktemp(n) for n in ("slam_jax", "slam_port"))
    argv = SLAM + ["--ckpt-every", 4, "--out", str(ja)]
    jl, pl = _both(argv, swap={str(ja): str(po)})
    return ja, po, jl, pl


def test_slam_matches(slam_runs):
    """Counters, loop lines, trajectory, map and checkpoint files of the
    8-frame run (three windows)."""
    ja, po, jl, pl = slam_runs
    assert _same_summary(jl, pl)["frames"] == 8
    assert [line for line in jl if "loop closed" in line] == \
        [line for line in pl if "loop closed" in line]
    _same_outputs(ja, po)
    assert sorted(p.name for p in ja.glob("engine_*.npz")) == \
        sorted(p.name for p in po.glob("engine_*.npz")) != []


def test_slam_resume_matches(slam_runs, tmp_path):
    """The port resumed from its own first checkpoint ends exactly where
    its uninterrupted run did; resumed from the JAX package's checkpoint
    it ends where the JAX package's own resumed run does, within the
    spread."""
    ja, po, jl, pl = slam_runs
    stem = sorted(p.name for p in po.glob("engine_*.npz"))[0][:-len(".npz")]
    own = _run(cli.main, PORT_SLAM + ["--resume", po / stem,
                                      "--out", tmp_path / "own"])
    assert own[0] == f"resumed at frame 4 from {po / stem}"
    want, got = _summary(pl), _summary(own)
    # dynamic_clusters counts the windows of this process only
    assert got[0].pop("dynamic_clusters") <= want[0].pop("dynamic_clusters")
    assert got == want
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / "own" / "trajectory.txt"),
        np.loadtxt(po / "trajectory.txt"), rtol=0, atol=RESUME_ATOL)
    rj = _run(jcli.main, SLAM + ["--resume", ja / stem,
                                 "--out", tmp_path / "jax"])
    cross = _run(cli.main, PORT_SLAM + ["--resume", ja / stem,
                                        "--out", tmp_path / "cross"])
    assert rj[0] == cross[0] == f"resumed at frame 4 from {ja / stem}"
    _same_summary(rj, cross)
    _same_outputs(tmp_path / "jax", tmp_path / "cross")


def test_slam_streams_a_kitti_directory(tmp_path):
    """`--data <dir>` over a sequence written from the tiny scene: the
    prefetcher, the decoder and the down-sampling of both packages feed
    the engines the same scans. Five scans make two engine windows (4 + a
    flush of 1, with an ERASOR pass); on these down-sampled scans the run is
    well conditioned, so every pose is held to the pose tolerance against
    the jitted JAX CLI and every counter is equal."""
    cfg = config.tiny_test()
    spec = synthetic.SceneSpec(
        ground_pts=1500, building_pts=300, tree_pts=100, car_pts=120,
        n_buildings=2, n_trees=3, n_parked_cars=2, n_moving_cars=2,
        extent=14.0, moving_speed=4.0, ego_speed=1.0, seed=0)
    win = synthetic.render_window(synthetic.make_scene(spec), 5,
                                  cfg.shapes.max_points)
    data = tmp_path / "velodyne"
    data.mkdir()
    # cfg.skip = 5: files 0, 5, 10, 15, 20 stream through; they hold the
    # consecutive frames 0..4, so the motion per step is the scene's own
    for i in range(21):
        f = i // 5
        v = win["valid"][f]
        np.concatenate([win["xyz"][f][v],
                        (win["intensity"][f][v] / 255.0)[:, None]],
                       axis=1).astype(np.float32).tofile(
            data / f"{i:06d}.bin")
    ja, po = tmp_path / "jax", tmp_path / "port"
    jl, pl = _both(["slam", "--profile", "tiny_test", "--data", str(data),
                    "--end", 21, "--window", 4, "--out", str(ja)],
                   swap={str(ja): str(po)})
    assert _same_summary(jl, pl, exact=True)["frames"] == 5
    assert _summary(pl)[0]["erasor_removed"] > 0
    assert _summary(pl)[1] is None          # no ground-truth poses: no ATE
    traj = _same_outputs(ja, po, atol=POSE_ATOL, map_rtol=1e-3)
    # the scene moves 1 m a frame: the poses held above are not identities
    assert len(traj) == 5 and np.abs(traj[-1] - traj[0]).max() > 2.0


@pytest.mark.slow
def test_slam_matches_the_eager_jax_run(tmp_path):
    """The JAX package run without jit, as the port runs: the trajectories
    then agree within the pose tolerance (takes ~3 min)."""
    import jax
    with jax.disable_jit():
        jl = _run(jcli.main, SLAM + ["--out", tmp_path / "jax"])
    pl = _run(cli.main, PORT_SLAM + ["--out", tmp_path / "port"])
    assert _summary(jl)[0]["frames"] == _summary(pl)[0]["frames"] == 8
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / "port" / "trajectory.txt"),
        np.loadtxt(tmp_path / "jax" / "trajectory.txt"), rtol=0,
        atol=POSE_ATOL)


# ------------------------------------------------------- the file tools

def _labeled_map(rng, n_static=1000, n_dynamic=200):
    gt = (rng.normal(size=(n_static + n_dynamic, 4)) * 10).astype(np.float32)
    gt[:, 3] = 40
    gt[n_static:, 3] = 252
    return gt


def test_evaluate_matches(tmp_path, rng):
    gt = _labeled_map(rng)
    est = np.concatenate([gt[:900], gt[1000:1050]])   # 100 lost, 50 kept
    io_kitti.write_pcd_xyzi(tmp_path / "gt.pcd", gt)
    io_kitti.write_pcd_xyzi(tmp_path / "est.pcd", est)
    jl, pl = _both(["evaluate", "--gt", tmp_path / "gt.pcd",
                    "--est", tmp_path / "est.pcd"])
    assert jl == pl
    assert pl[0].startswith("PR=90.00  RR=75.00") and "class 252" in pl[1]


def test_evaluate_map_matches(tmp_path, rng):
    gt = _labeled_map(rng, 300, 100)
    noise = rng.normal(scale=0.03, size=(400, 3)).astype(np.float32)
    moved = gt.copy()
    moved[:, :3] += noise
    io_kitti.write_pcd_xyzi(tmp_path / "gt.pcd", gt)
    io_kitti.write_pcd_xyzi(tmp_path / "s.pcd",
                            np.concatenate([moved[:250], moved[300:330]]))
    io_kitti.write_pcd_xyzi(tmp_path / "d.pcd",
                            np.concatenate([moved[250:290], moved[330:]]))
    oj, op = tmp_path / "ej.pcd", tmp_path / "ep.pcd"
    jl, pl = _both(["evaluate-map", "--gt", tmp_path / "gt.pcd",
                    "--static", tmp_path / "s.pcd",
                    "--dynamic", tmp_path / "d.pcd", "--out", str(oj)],
                   swap={str(oj): str(op)})
    assert jl[0].split(" -> ")[0] == pl[0].split(" -> ")[0]
    counts = dict(kv.split("=") for kv in pl[0].split(" -> ")[0].split())
    assert all(int(counts[k]) > 0 for k in ("TP", "FN", "TN", "FP",
                                            "dropped"))
    a, _ = io_session.read_pcd_fields(oj)
    b, _ = io_session.read_pcd_fields(op)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_colorize_pcd2bin_sydney_match(tmp_path, rng):
    pts = rng.normal(size=(100, 4)).astype(np.float32)
    pts.tofile(tmp_path / "000000.bin")
    rec = np.zeros(50, dtype=io_sydney.SYDNEY_DTYPE)
    for name in ("x", "y", "z", "intensity"):
        rec[name] = rng.integers(0, 200, 50)
    rec.tofile(tmp_path / "obj.bin")
    outs = {}
    for tag, main in (("jax", jcli.main), ("port", cli.main)):
        d = tmp_path / tag
        d.mkdir()
        lines = _run(main, ["colorize", "--bin", tmp_path / "000000.bin",
                            "--out", d / "0.pcd"])
        lines += _run(main, ["pcd2bin", "--pcd", d, "--out", d / "bins"])
        lines += _run(main, ["sydney", "--bin", tmp_path / "obj.bin",
                             "--out", d / "obj.pcd"])
        outs[tag] = ([line.split(" -> ")[0] for line in lines],
                     io_kitti.read_pcd_xyzi(d / "0.pcd"),
                     np.fromfile(d / "bins" / "0.bin", np.float32),
                     io_kitti.read_pcd_xyzi(d / "obj.pcd"))
    np.testing.assert_array_equal(outs["port"][1], pts)
    assert outs["jax"][0] == outs["port"][0] == ["100 pts", "1 scans",
                                                 "50 pts"]
    for a, b in zip(outs["jax"][1:], outs["port"][1:]):
        np.testing.assert_array_equal(a, b)


def test_erasor_matches(tmp_path, rng):
    """A ground disc with a car box in the map and not in the scan."""
    def scene(with_car):
        r = np.sqrt(rng.uniform(4.0, 40.0 ** 2, 4000))
        th = rng.uniform(0, 2 * np.pi, 4000)
        parts = [np.stack([r * np.cos(th), r * np.sin(th),
                           rng.normal(scale=0.02, size=4000) - 1.7], 1)]
        if with_car:
            parts.append(np.stack([rng.uniform(8, 12.2, 600),
                                   rng.uniform(-0.9, 0.9, 600),
                                   rng.uniform(-1.7, -0.2, 600)], 1))
        xyz = np.concatenate(parts).astype(np.float32)
        return np.concatenate([xyz, np.zeros((len(xyz), 1), np.float32)], 1)

    io_kitti.write_pcd_xyzi(tmp_path / "map.pcd", scene(True))
    io_kitti.write_pcd_xyzi(tmp_path / "scan.pcd", scene(False))
    outs = {}
    for tag, main, dev in (("jax", jcli.main, []),
                           ("port", cli.main, ["--device", "cpu"])):
        lines = _run(main, ["erasor", *dev, "--map", tmp_path / "map.pcd",
                            "--scan", tmp_path / "scan.pcd",
                            "--ego", "[0, 0, 0]",
                            "--out-static", tmp_path / f"{tag}_s.pcd",
                            "--out-dynamic", tmp_path / f"{tag}_d.pcd"])
        outs[tag] = (lines, io_kitti.read_pcd_xyzi(tmp_path / f"{tag}_s.pcd"),
                     io_kitti.read_pcd_xyzi(tmp_path / f"{tag}_d.pcd"))
    assert outs["jax"][0] == outs["port"][0]
    assert len(outs["port"][2]) > 0
    np.testing.assert_array_equal(outs["jax"][1], outs["port"][1])
    np.testing.assert_array_equal(outs["jax"][2], outs["port"][2])


def test_iou_remain_merge_match(tmp_path, rng):
    n = 600
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    gt_lab = rng.choice([50, 51, 70, 72, 10, 252, 40], n)
    est_lab = rng.choice([0, 1, 2, 3], n)
    io_kitti.write_pcd_xyzi(tmp_path / "gt.pcd",
                            np.concatenate([xyz, gt_lab[:, None]], 1))
    io_kitti.write_pcd_xyzi(tmp_path / "est.pcd",
                            np.concatenate([xyz, est_lab[:, None]], 1))
    pairs = tmp_path / "pairs"
    pairs.mkdir()
    for i in range(5):          # the fifth file has no partner
        io_kitti.write_pcd_xyzi(
            pairs / f"{i}.pcd",
            rng.normal(size=(20 + i, 4)).astype(np.float32))
    for argv, files in (
            (["iou", "--gt", tmp_path / "gt.pcd",
              "--est", tmp_path / "est.pcd"], []),
            (["remain", "--map", tmp_path / "gt.pcd", "--out", "OUT/r.pcd"],
             ["r.pcd"]),
            (["merge", "--dir", pairs, "--out", "OUT"],
             ["0.pcd", "1.pcd"])):
        lines = {}
        for tag, main in (("jax", jcli.main), ("port", cli.main)):
            out = tmp_path / f"{argv[0]}_{tag}"
            lines[tag] = [
                line.split(" -> ")[0] for line in _run(
                    main, [str(a).replace("OUT", str(out)) for a in argv])]
        assert lines["jax"] == lines["port"] and lines["port"]
        for name in files:
            a, fa = io_session.read_pcd_fields(
                tmp_path / f"{argv[0]}_jax" / name)
            b, fb = io_session.read_pcd_fields(
                tmp_path / f"{argv[0]}_port" / name)
            assert fa == fb
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))


def test_bench_table_matches(tmp_path):
    """One YAML profile, one threshold: 4 rows (full, -RI3, -TC,
    ours+sweep), equal to the digits printed."""
    (tmp_path / "seq00.yaml").write_text(
        "sequence: {id: '00', start: 0, end: 10}\n"
        "ssc: {occupancy_: 0.4, search_c_: 2}\n")
    jl, pl = _both(["bench-table", *TINY, "--frames", 3,
                    "--profiles", tmp_path, "--thresholds", "0.2"])
    assert jl == pl
    assert len(pl) == 2 + 4 and pl[2].startswith("| 00 | full | 0.2 |")
    assert pl[-1].startswith("| 00 | ours+sweep | 0.4 |")
