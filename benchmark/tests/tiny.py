"""Tiny cells for the harness's CPU tests: a copy of the benchmark's tree
in a temporary root, with one tiny cell per driver written as files alone
(a configuration, a cell and a BENCHMARK.json entry), and the runner
pointed at that root."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

from benchmark import harness

SCENE_LINE = {"trajectory": "line", "ground_pts": 1500, "building_pts": 300,
              "tree_pts": 100, "car_pts": 120, "n_buildings": 2,
              "n_trees": 3, "n_parked_cars": 2, "n_moving_cars": 2,
              "extent": 14.0, "moving_speed": 4.0, "ego_speed": 1.0,
              "mover_path": "ego_wrap", "path_frames": 4}
SCENE_LOOP = {"trajectory": "loop", "loop_frames": 8, "loop_radius": 8.0,
              "ground_pts": 1500, "building_pts": 300, "tree_pts": 100,
              "car_pts": 120, "n_buildings": 2, "n_trees": 3,
              "n_parked_cars": 2, "n_moving_cars": 2, "extent": 14.0,
              "moving_speed": 4.0}


def tiny_configs():
    """(pipeline dict, engine dict) at the port's tiny_test() sizes."""
    from dr_using_scv_od_tpu_torch import config
    from dr_using_scv_od_tpu_torch.models import engine
    pipe = json.loads(json.dumps(dataclasses.asdict(config.tiny_test())))
    ec = engine.EngineConfig(window=4, max_keyframes=16, submap_points=256,
                             kf_dist=0.5, loop_min_gap=4, loop_min_score=0.5,
                             max_loop_edges=8, pgo_gn_iters=2,
                             pgo_cg_iters=8, erasor_every=2)
    return pipe, json.loads(json.dumps(dataclasses.asdict(ec)))


def make_root(tmp: Path, monkeypatch) -> Path:
    """A root under `tmp` with the repo's BENCHMARK.json and benchmark/
    tree, plus the tiny cells `tiny-removal` and `tiny-slam`, added as new
    files and new entries only; the harness is pointed at it."""
    root = tmp / "root"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.benchmark_spec()
    pipe, ec = tiny_configs()
    limits = {}
    for name in ("removal-seq00", "slam-seq00-loop"):
        limits[name] = harness.workload(name)["limits"]
    cells = {
        "tiny-removal": ("tiny-pipeline", "removal_window",
                         {"name": "tiny-pool2", "windows": 2, "frames": 4,
                          "scene": SCENE_LINE},
                         limits["removal-seq00"], "removal_ms_per_frame"),
        "tiny-slam": ("tiny-engine", "slam_session",
                      {"name": "tiny-loop", "windows": 1, "frames": 10,
                       "scene": SCENE_LOOP},
                      limits["slam-seq00-loop"], "slam_ms_per_frame"),
    }
    for cfg_name, engine_doc in (("tiny-pipeline", None),
                                 ("tiny-engine", ec)):
        (root / "benchmark" / "configs" / f"{cfg_name}.json").write_text(
            json.dumps({"name": cfg_name, "pipeline": pipe,
                        "engine": engine_doc, "reduced": []}))
        spec["configs"].append({"name": cfg_name, "source": "tiny_test",
                                "file": f"benchmark/configs/{cfg_name}.json",
                                "reduced": [], "why": "CPU tests"})
    for cell, (cfg_name, driver, traffic, lim, e2e) in cells.items():
        (root / "benchmark" / "workloads" / f"{cell}.json").write_text(
            json.dumps({"name": cell, "config": cfg_name, "driver": driver,
                        "traffic": traffic, "why": "CPU tests",
                        "limits": lim}))
        spec["workloads"].append({"name": cell, "config": cfg_name,
                                  "traffic": traffic["name"], "chips": 1,
                                  "why": "CPU tests"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if m["name"] == e2e or m.get("moves") == e2e:
                m.setdefault("workloads", []).append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "BENCH", root / "benchmark")
    return root
