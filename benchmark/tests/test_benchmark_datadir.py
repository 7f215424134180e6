"""The `slam-datadir` cell: found from its files alone, and its driver
(`drivers/slam_datadir.py`) run whole on the CPU at tiny size, where it
reads `correct` true, its traced run carries the stream's metrics, and a
down-sample planted wrong (the last point of a leaf kept, or a 0.1 m
leaf) reads `correct` false by `scan_diff_points`."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from benchmark import harness, run
from benchmark.reference import build
from benchmark.tests import tiny
from benchmark.traffic import generator, synthetic
from dr_using_scv_od_tpu_torch.utils import io_kitti

CPU = torch.device("cpu")
CELL = "tiny-datadir"
METRICS = {"datadir.downsample_ms_per_frame",
           "datadir.scan_read_ms_per_frame", "datadir.device_idle_pct",
           "datadir.native_read_share_pct"}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def root(tmp_path, monkeypatch):
    """tiny.make_root's root plus `tiny-datadir`: the tiny engine behind a
    KITTI directory of 10 scans at tiny_test()'s 4,096 points, added as
    files and entries alone."""
    root = tiny.make_root(tmp_path, monkeypatch)
    pipe, ec = tiny.tiny_configs()
    doc = harness.config_doc("kitti00-slam-datadir")
    N = pipe["shapes"]["max_points"]
    inp = dict(doc["input"], files=10 * pipe["skip"], end=10 * pipe["skip"],
               scans_read=10, skip=pipe["skip"], decode_cap_points=4 * N,
               padded_points=N)
    (root / "benchmark" / "configs" / "tiny-datadir.json").write_text(
        json.dumps({"name": "tiny-datadir", "input": inp, "pipeline": pipe,
                    "engine": ec, "reduced": []}))
    limits = harness.workload("slam-datadir")["limits"]
    traffic = {"name": "tiny-loop-datadir", "windows": 1, "frames": 10,
               "scene": tiny.SCENE_LOOP}
    (root / "benchmark" / "workloads" / f"{CELL}.json").write_text(
        json.dumps({"name": CELL, "config": "tiny-datadir",
                    "driver": "slam_datadir", "traffic": traffic,
                    "why": "CPU tests", "control": "tf32",
                    "limits": limits}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-datadir", "source": "tiny_test",
                            "file": "benchmark/configs/tiny-datadir.json",
                            "reduced": [], "why": "CPU tests"})
    spec["workloads"].append({"name": CELL, "config": "tiny-datadir",
                              "traffic": traffic["name"], "chips": 1,
                              "why": "CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] == "slam_ms_per_frame" or m["name"] in METRICS:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run(trace, seconds=0.2, seed=2 ** 33 + 17):
    return run.run_cell(CELL, seed, seconds, trace, CPU,
                        t_start=time.perf_counter())


def test_the_cell_is_found_from_its_files_alone():
    spec = harness.benchmark_spec()
    assert set(harness.per_layer_names(spec, "slam-datadir")) == METRICS
    assert harness.end_to_end_names(spec, "slam-datadir") == [
        "slam_ms_per_frame", "setup_s"]
    wl = harness.workload("slam-datadir")
    entry = harness.cell_entry(spec, "slam-datadir")
    assert wl["traffic"]["name"] == entry["traffic"]
    assert wl["config"] == entry["config"] == "kitti00-slam-datadir"
    assert entry["chips"] == 1
    assert callable(harness.load_module("drivers", wl["driver"]).check)
    doc = harness.config_doc(wl["config"])
    # the engine and pipeline are kitti00-slam's, every field given
    slam = harness.config_doc("kitti00-slam")
    assert (doc["pipeline"], doc["engine"]) == (slam["pipeline"],
                                                slam["engine"])
    cfg, ec = harness.port_configs(doc)
    assert build.pipeline_config(doc) is not None
    inp = doc["input"]
    assert len(range(inp["start"], inp["end"], inp["skip"])) == \
        inp["scans_read"] == wl["traffic"]["frames"] == 76
    assert (inp["padded_points"], inp["decode_cap_points"], inp["skip"]) == (
        cfg.shapes.max_points, 4 * cfg.shapes.max_points, cfg.skip)
    assert [c for c in spec["configs"] if c["name"] == wl["config"]][0][
        "reduced"] == doc["reduced"]


def test_the_written_scans_hold_120k_points():
    """The scene's scale gives a mean written scan of 120,000 +- 5 %."""
    traffic = harness.workload("slam-datadir")["traffic"]
    scene = generator.scene(traffic, 2 ** 35 + 3, 0)
    n = [len(synthetic.render_frame(scene, f)[0])
         for f in range(0, traffic["frames"], 5)]
    assert 0.95 * 120_000 < np.mean(n) < 1.05 * 120_000


def test_a_tiny_run_is_correct(root):
    res = _run(False)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"slam_ms_per_frame", "setup_s"}
    assert set(res["checks"]) == set(harness.workload(
        "slam-datadir")["limits"])
    assert all(c["value"] == 0.0 for c in res["checks"].values())


def test_a_traced_run_carries_the_stream_metrics(root):
    res = _run(True)
    assert res["correct"] is True, res["checks"]
    # on the CPU no device trace exists: the idle share finds nothing
    got = set(res["metrics"])
    assert {"datadir.downsample_ms_per_frame",
            "datadir.scan_read_ms_per_frame",
            "datadir.native_read_share_pct"} <= got <= METRICS
    assert "datadir.device_idle_pct" not in got
    assert res["metrics"]["datadir.downsample_ms_per_frame"]["value"] > 0
    native = io_kitti._native() is not None
    assert res["metrics"]["datadir.native_read_share_pct"]["value"] == (
        100.0 if native else 0.0)
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _last_per_leaf(orig):
    """The last point of each leaf kept instead of the first."""
    return lambda xyz, leaf: orig(xyz[::-1], leaf)[::-1].copy()


def _wide_leaf(orig):
    """A 0.1 m leaf instead of 0.08 m."""
    return lambda xyz, leaf: orig(xyz, 0.1)


FAULTS = {"last-point-per-leaf": _last_per_leaf, "leaf-0.1m": _wide_leaf}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_wrong_downsample_is_not_correct(root, monkeypatch, fault):
    monkeypatch.setattr(io_kitti, "_voxel_downsample_np",
                        FAULTS[fault](io_kitti._voxel_downsample_np))
    res = _run(False)
    assert res["correct"] is False
    assert res["checks"]["scan_diff_points"]["value"] > 0
    assert res["failed"] >= 1
