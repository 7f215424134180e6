"""The harness on the CPU at tiny sizes: cells, configurations, drivers and
metrics are found by name (a cell added as files alone is picked up), the
result line's keys, both drivers with the reference agreeing, the tiled
scene generator, the trace reduction and the roofline's byte count."""

from __future__ import annotations

import dataclasses
import json
import re
import time

import numpy as np
import pytest
import torch

from benchmark import harness, run
from benchmark.reference import build
from benchmark.tests import tiny
from benchmark.traffic import generator, synthetic

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def root(tmp_path, monkeypatch):
    return tiny.make_root(tmp_path, monkeypatch)


def _run(cell, trace, seconds=0.2, seed=2 ** 31 + 11):
    return run.run_cell(cell, seed, seconds, trace, CPU,
                        t_start=time.perf_counter())


@pytest.mark.parametrize("cell,e2e", [("tiny-removal", "removal_ms_per_frame"),
                                      ("tiny-slam", "slam_ms_per_frame")])
def test_a_cell_added_as_files_runs_by_name(root, cell, e2e):
    res = _run(cell, False)
    assert list(res) == KEYS + ["checks"]          # checks come last
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {e2e, "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0
    assert all(c["value"] == 0.0 for c in res["checks"].values())


@pytest.mark.parametrize("cell,spans", [
    ("tiny-removal", {"removal.patchwork_ms_per_frame",
                      "removal.tracking_ms_per_frame"}),
    ("tiny-slam", {"slam.odometry_ms_per_frame", "slam.loops_ms_per_frame"})])
def test_a_traced_run_carries_breakdown_and_span_metrics(root, cell, spans):
    res = _run(cell, True)
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert res["correct"] is True
    # on the CPU no device trace exists: only the span metrics read
    assert spans <= set(res["metrics"]) <= spans | {
        "slam.pgo_ms_per_frame"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "removal-seq00", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no result" in out.err


def test_per_layer_metrics_follow_benchmark_json():
    spec = harness.benchmark_spec()
    assert set(harness.per_layer_names(spec, "slam-seq00-loop")) == {
        "slam.device_idle_pct", "slam.launches_per_frame",
        "slam.segment_reduce_ms_per_frame", "slam.odometry_ms_per_frame",
        "slam.loops_ms_per_frame", "slam.pgo_ms_per_frame"}
    assert harness.end_to_end_names(spec, "removal-seq00") == [
        "removal_ms_per_frame", "setup_s"]


def test_benchmark_json_keeps_the_contract():
    spec = harness.benchmark_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in spec["configs"]:
        doc = json.loads((harness.ROOT / c["file"]).read_text())
        cfg, ec = harness.port_configs(doc)       # every field is given
        assert build.pipeline_config(doc) is not None
        assert doc["reduced"] == c["reduced"]
        assert all(k in doc for k in c["reduced"])
    for w in spec["workloads"]:
        wl = harness.workload(w["name"])
        assert wl["config"] == w["config"] and len(w["why"]) <= 200
        assert wl["traffic"]["name"] == w["traffic"] and w["chips"] == 1
        harness.load_module("drivers", wl["driver"])
        for m in harness.per_layer_names(spec, w["name"]):
            assert m in {p["name"] for p in spec["per_layer"]}


def test_tiled_scene_keeps_the_default_density_in_every_frame():
    traffic = harness.workload("removal-seq00")["traffic"]
    ref = synthetic.render_frame(synthetic.make_scene(), 0)[2]
    for seed in (1, 2 ** 33 + 5):
        spec = generator.scene_spec(traffic, seed, 0)
        scene = synthetic.make_scene(spec)
        assert len(scene.buildings) == 3 * spec.n_buildings   # three tiles
        for f in range(0, traffic["frames"], 3):
            label = synthetic.render_frame(scene, f)[2]
            assert 0.7 * len(ref) < len(label) < 1.3 * len(ref), f
            # every mover in view, every frame
            assert (label == synthetic.LABEL_CAR_MOVING).sum() == \
                spec.n_moving_cars * spec.car_pts
            for lab in (synthetic.LABEL_BUILDING, synthetic.LABEL_TREE,
                        synthetic.LABEL_CAR_STATIC):
                assert (label == lab).sum() > 0.1 * (ref == lab).sum(), f


def test_the_generator_is_a_function_of_the_seed():
    traffic = dict(harness.workload("removal-seq00")["traffic"],
                   windows=2, frames=2)
    a = generator.render(traffic, 2 ** 40 + 3, 4096)
    b = generator.render(traffic, 2 ** 40 + 3, 4096)
    c = generator.render(traffic, 2 ** 40 + 4, 4096)
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not np.array_equal(a[0]["xyz"], c[0]["xyz"])
    assert not np.array_equal(a[0]["xyz"], a[1]["xyz"])
    assert generator.window_seed(-5, 0) != generator.window_seed(5, 0)


def test_the_default_scene_is_the_ports():
    from dr_using_scv_od_tpu_torch.utils import synthetic as port
    a = synthetic.render_frame(synthetic.make_scene(), 4)
    b = port.render_frame(port.make_scene(), 4)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_roofline_bytes_pinned():
    roof = harness.load_module("metrics",
                               "removal.cluster_labels_roofline_pct")
    assert roof.bound_bytes(1_296_000, 8_947) == 6_551_576


def _trace():
    # two kernels with a 1 ms gap, a copy, the clock marker at t0 + 1 us
    t0 = 1_000_000
    ops = [(harness.MARKER, t0 + 1_000, 100),
           ("void at::native::segment_reduce_forward_kernel<float>(int)",
            t0 + 2_000, 1_000_000),
           ("Memcpy DtoH (Device -> Pinned)", t0 + 1_002_000, 10_000),
           ("tile_pass_kernel<false>(Occ)", t0 + 2_002_000, 500_000)]
    return harness.Trace(ops=ops, host_t0=0, host_t1=3_002_000,
                         offset=t0)


def test_trace_reduction_and_breakdown():
    tr = _trace()
    assert tr.window_s == pytest.approx(3.002e-3)
    assert tr.busy_s == pytest.approx(1.51e-3)
    assert len(tr.kernels) == 2
    spans = harness.Spans(CPU, False, [])
    spans.log = [("tracking", 1_003_000, 1_900_000, 1),
                 ("run_window", 0, 3_000_000, 0)]
    bd = harness.breakdown(tr, spans)
    assert bd["device_ops"][0] == ["segment_reduce_forward_kernel", 1e-3]
    names = dict(bd["idle_gaps"])
    assert names["tracking"] == pytest.approx(0.99e-3)
    assert names["run_window"] == pytest.approx(0.5e-3 + 2e-6)
    ctx = {"trace": tr, "profiled_frames": 2, "wall_s": 4e-3,
           "wall_frames": 2, "occupied_voxels": [10, 20],
           "grid_voxels": 100, "span_s": {"pgo": 0.5},
           "span_self_s": {"finalize": 0.25}, "span_frames": 5}
    read = lambda name: harness.load_module("metrics", name).read(ctx)
    # idle against the wall time of the same work with no profiler
    assert read("removal.device_idle_pct") == pytest.approx(
        100 * (1 - 1.51 / 4.0))
    assert read("removal.launches_per_frame") == 1.0
    assert read("slam.segment_reduce_ms_per_frame") == pytest.approx(0.5)
    assert read("removal.cluster_labels_roofline_pct") == pytest.approx(
        100 * (2 * 500 + 8 * 30) / harness.HBM_BYTES_PER_S / 5e-4)
    assert read("slam.pgo_ms_per_frame") == pytest.approx(150.0)
    assert read("slam.odometry_ms_per_frame") is None
    empty = dict(ctx, trace=harness.Trace([], 0, 10, None))
    assert harness.load_module("metrics", "slam.device_idle_pct").read(
        empty) is None


@pytest.mark.parametrize("record", [True, False])
def test_spans_record_self_time(record):
    class Mod:
        @staticmethod
        def inner():
            time.sleep(0.01)

        @staticmethod
        def outer():
            Mod.inner()
            time.sleep(0.01)

    spans = harness.Spans(CPU, True, [(Mod, "inner", "i"),
                                      (Mod, "outer", "o")], record=record)
    with spans:
        Mod.outer()
    assert Mod.outer.__name__ == "outer" and set(spans.seconds) == {"i", "o"}
    assert spans.seconds["o"] > spans.self_seconds["o"] >= 0.009
    assert spans.self_seconds["i"] == spans.seconds["i"]


def test_config_files_build_both_sides_alike():
    for name in ("kitti00-removal", "kitti00-slam"):
        doc = harness.config_doc(name)
        cfg, ec = harness.port_configs(doc)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            build.pipeline_config(doc))
        if ec is not None:
            assert dataclasses.asdict(ec) == dataclasses.asdict(
                build.engine_config(doc))
        bad = dict(doc, pipeline=dict(doc["pipeline"], extra=1))
        with pytest.raises(KeyError):
            harness.port_configs(bad)
