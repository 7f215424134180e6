"""`pipeline.segdf_window`, the one entry of `cli segdf` (and of the
benchmark's `removal-seq00-odom` cell), on the CPU at tiny_test() sizes
over a 5-frame window of a small scene with two movers:

  * with `estimate_poses` its poses and per-point outputs equal the
    benchmark's plain reference (`benchmark/reference`: its odometry, then
    its run_window on the poses it estimated) bit for bit: both are the
    plain path on the CPU;
  * without, it is `run_window` on the poses it is given;
  * inside `timing.recording()` the odometry is one span
    `window_odometry` a window and adds F - 1 to the count
    `odometry.pairs`; a StageTimer adds its stages `odometry` and
    `pipeline` around the two steps.

The entry on the card against the CPU is a card test
(tests/test_torch_cuda.py)."""

import pytest
import torch

from benchmark.reference import config as ref_config
from benchmark.reference.models import odometry as ref_odometry
from benchmark.reference.models import pipeline as ref_pipeline
from dr_using_scv_od_tpu_torch import config, interop
from dr_using_scv_od_tpu_torch.models import pipeline
from dr_using_scv_od_tpu_torch.utils import synthetic, timing

F = 5


@pytest.fixture(scope="module")
def window():
    spec = synthetic.SceneSpec(ground_pts=1500, building_pts=300,
                               tree_pts=100, car_pts=120, n_buildings=2,
                               n_trees=3, n_parked_cars=2, n_moving_cars=2,
                               extent=14.0, moving_speed=4.0, ego_speed=1.0,
                               seed=0)
    cfg = config.tiny_test()
    win = synthetic.render_window(synthetic.make_scene(spec), F,
                                  cfg.shapes.max_points)
    return interop.window_from_numpy(win, "cpu")


@pytest.fixture(scope="module")
def estimated(window):
    xyz, intensity, valid, _ = window
    return pipeline.segdf_window(xyz, intensity, valid, None,
                                 config.tiny_test(), estimate_poses=True)


def _outputs(res):
    return (res.removed, res.point_cluster, res.frames.state.point_route,
            res.label_grids)


def test_the_entry_is_the_reference_with_estimated_poses(window, estimated):
    xyz, intensity, valid, gt = window
    cfg = ref_config.tiny_test()
    poses = ref_odometry.estimate_window_poses(xyz, valid, cfg).poses
    ref = ref_pipeline.run_window(xyz, intensity, valid, poses, cfg)
    assert estimated.poses.shape == (F, 4, 4)
    assert torch.equal(estimated.poses, poses)
    assert not torch.equal(estimated.poses, gt)      # estimated, not given
    for a, b in zip(_outputs(estimated.window), _outputs(ref)):
        assert torch.equal(a, b)
    assert int(estimated.window.removed.sum()) > 0


def test_the_entry_without_estimation_is_run_window(window):
    cfg = config.tiny_test()
    got = pipeline.segdf_window(*window, cfg, estimate_poses=False)
    want = pipeline.run_window(*window, cfg)
    assert got.poses is window[3]
    for a, b in zip(_outputs(got.window), _outputs(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("stages", [False, True], ids=["entry", "timer"])
def test_the_window_odometry_is_one_span_with_its_pairs(window, estimated,
                                                        stages, tmp_path):
    xyz, intensity, valid, _ = window
    timer = timing.StageTimer(tmp_path / "time.txt") if stages else None
    with timing.recording() as rec:
        got = pipeline.segdf_window(xyz, intensity, valid, None,
                                    config.tiny_test(), estimate_poses=True,
                                    timer=timer)
    names = [s.name for s in rec.spans]
    assert names.count("window_odometry") == 1
    assert names.count("run_window") == 1
    assert rec.counts["odometry.pairs"] == F - 1
    assert names.index("window_odometry") < names.index("run_window")
    odo = rec.spans[names.index("window_odometry")]
    if stages:
        assert rec.spans[odo.parent].name == "odometry"
        assert {"odometry", "pipeline"} <= set(names)
        assert list(timer.end_frame()) == ["odometry", "pipeline"]
    else:
        assert odo.depth == 0
        assert "odometry" not in names and "pipeline" not in names
    assert torch.equal(got.poses, estimated.poses)
