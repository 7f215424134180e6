"""The `removal-seq00-odom` cell: found from its files alone, and its driver
(`drivers/removal_odom.py`) run whole on the CPU at tiny size, where it
reads `correct` true and its traced run carries the window odometry's
span metric; a pose planted wrong in the port's odometry (one pair's
relative pose nudged by 0.1 m) reads `correct` false by `pose_gap_m`,
and so does the control. The control at the cell's full size needs a
CUDA card:

    python -m pytest benchmark/tests/test_benchmark_odom.py -q -m cuda
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import harness, run
from benchmark.tests import tiny
from dr_using_scv_od_tpu_torch.models import posegraph

CPU = torch.device("cpu")
CELL = "tiny-removal-odom"
FULL = "removal-seq00-odom"
METRICS = {"odom.window_odometry_ms_per_frame",
           "odom.odometry_device_ms_per_frame", "odom.device_idle_pct",
           "odom.host_syncs_per_frame"}
SEED = 2 ** 33 + 29


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def root(tmp_path, monkeypatch):
    """tiny.make_root's root plus `tiny-removal-odom`: the tiny pipeline
    behind the odometry over 2 windows of 4 frames, added as files and
    entries alone."""
    root = tiny.make_root(tmp_path, monkeypatch)
    pipe, _ = tiny.tiny_configs()
    (root / "benchmark" / "configs" / "tiny-odom.json").write_text(
        json.dumps({"name": "tiny-odom", "pipeline": pipe, "engine": None,
                    "reduced": []}))
    wl = harness.workload(FULL)
    traffic = {"name": "tiny-pool2-odom", "windows": 2, "frames": 4,
               "scene": tiny.SCENE_LINE}
    (root / "benchmark" / "workloads" / f"{CELL}.json").write_text(
        json.dumps({"name": CELL, "config": "tiny-odom",
                    "driver": wl["driver"], "traffic": traffic,
                    "why": "CPU tests", "control": wl["control"],
                    "limits": wl["limits"]}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-odom", "source": "tiny_test",
                            "file": "benchmark/configs/tiny-odom.json",
                            "reduced": [], "why": "CPU tests"})
    spec["workloads"].append({"name": CELL, "config": "tiny-odom",
                              "traffic": traffic["name"], "chips": 1,
                              "why": "CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] == "removal_ms_per_frame" or m["name"] in METRICS:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run(trace, seconds=0.2):
    return run.run_cell(CELL, SEED, seconds, trace, CPU,
                        t_start=time.perf_counter())


def test_the_cell_is_found_from_its_files_alone():
    spec = harness.benchmark_spec()
    assert set(harness.per_layer_names(spec, FULL)) == METRICS
    assert harness.end_to_end_names(spec, FULL) == [
        "removal_ms_per_frame", "setup_s"]
    wl = harness.workload(FULL)
    entry = harness.cell_entry(spec, FULL)
    assert wl["traffic"]["name"] == entry["traffic"] == "seq00-pool3-odom"
    assert wl["config"] == entry["config"] == "kitti00-removal-odom"
    assert entry["chips"] == 1
    assert set(wl["limits_why"]) == set(wl["limits"])
    # removal-seq00's pipeline and pool, every field given
    doc = harness.config_doc(wl["config"])
    removal = harness.config_doc("kitti00-removal")
    assert doc["pipeline"] == removal["pipeline"]
    assert doc["engine"] is None and doc["reduced"] == []
    pool = harness.workload("removal-seq00")["traffic"]
    assert {k: wl["traffic"][k] for k in ("windows", "frames", "scene")} == \
        {k: pool[k] for k in ("windows", "frames", "scene")}
    assert [c for c in spec["configs"] if c["name"] == wl["config"]][0][
        "source"] == doc["source"]


def test_a_tiny_run_is_correct(root):
    res = _run(False)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"removal_ms_per_frame", "setup_s"}
    assert set(res["checks"]) == set(harness.workload(FULL)["limits"])
    assert all(c["value"] == 0.0 for c in res["checks"].values())


def test_a_traced_run_carries_the_odometry_span(root):
    res = _run(True)
    assert res["correct"] is True, res["checks"]
    # on the CPU no device trace and no sync count exist: only the span
    assert set(res["metrics"]) == {"odom.window_odometry_ms_per_frame"}
    assert res["metrics"]["odom.window_odometry_ms_per_frame"]["value"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _nudged(pair):
    """odometry_chain composes the poses with one pair's relative pose
    moved 0.1 m along x."""
    def chain(rel_T):
        rel_T = rel_T.clone()
        rel_T[pair % rel_T.shape[0], 0, 3] += 0.1
        return chain.orig(rel_T)
    chain.orig = posegraph.odometry_chain
    return chain


@pytest.mark.parametrize("pair", [0, -1])
def test_a_nudged_pose_is_not_correct(root, monkeypatch, pair):
    monkeypatch.setattr(posegraph, "odometry_chain", _nudged(pair))
    res = _run(False, seconds=2.0)
    assert res["correct"] is False
    assert res["checks"]["pose_gap_m"]["value"] > 0.09
    assert res["failed"] >= 1


def test_the_control_is_not_correct(root):
    """TF32 moves nothing on the CPU, so here the control is the scans
    rounded to bfloat16; the card test below runs the cell's own."""
    wl = harness.workload(CELL)
    driver = harness.load_module("drivers", wl["driver"])
    state = driver.setup(harness.config_doc(wl["config"]), wl["traffic"],
                         SEED, CPU)
    program, control = driver.control(state, "bf16")
    limits = wl["limits"]
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control


@pytest.mark.cuda
def test_the_control_fails_and_the_port_passes_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at full width on it")
    device = torch.device("cuda", 0)
    wl = harness.workload(FULL)
    driver = harness.load_module("drivers", wl["driver"])
    harness.set_float32_matmul(False)
    state = driver.setup(harness.config_doc(wl["config"]), wl["traffic"],
                         2 ** 31 + 101, device)
    program, control = driver.control(state, wl["control"])
    limits = wl["limits"]
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control
