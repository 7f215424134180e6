"""The port's benchmark, dr_using_scv_od_tpu_torch/tools/bench.py, on the
CPU at the tiny_test() size (one rep, a short loop-scene sequence): its
one stdout line, its stderr sections, its failures, and the configuration
of its [slam] section against bench.py's, read from bench.py's source.
Tolerance: none (the checks are exact, but for vs_baseline, which holds to
the rounding of the two printed numbers)."""

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from dr_using_scv_od_tpu.models import engine as jengine
from dr_using_scv_od_tpu.utils import synthetic as jsynthetic
from dr_using_scv_od_tpu_torch import config
from dr_using_scv_od_tpu_torch.models import engine, pipeline
from dr_using_scv_od_tpu_torch.tools import bench
from dr_using_scv_od_tpu_torch.utils import synthetic

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_BENCH = ROOT / "bench.py"
PORT_BENCH = ROOT / "dr_using_scv_od_tpu_torch" / "tools" / "bench.py"
TINY = ["--device", "cpu", "--profile", "tiny_test", "--reps", "1",
        "--frames", "3", "--slam-frames", "36"]
PREFIXES = ("[device]", "[stages ms/frame]", "[roofline]", "[trace]",
            "[odometry]", "[slam]", "[engine-trace]", "[kernels]")
KEYS = {"metric", "value", "unit", "vs_baseline", "device"}
SECTIONS = {"headline", "stages", "roofline", "trace", "odometry", "slam",
            "engine-trace"}


def _run(code_or_args, timeout=400):
    """Run the bench in a fresh interpreter with one CPU thread (the test
    workers share the cores): `python -m ... <args>`, or `python -c <code>`
    for a string. Returns the CompletedProcess."""
    if isinstance(code_or_args, str):
        cmd = [sys.executable, "-c", code_or_args]
    else:
        cmd = [sys.executable, "-m", "dr_using_scv_od_tpu_torch.tools.bench",
               *code_or_args]
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))


@pytest.fixture(scope="module")
def tiny_run():
    proc = _run(TINY)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


def test_stdout_is_one_json_line(tiny_run):
    lines = tiny_run.stdout.splitlines()
    assert len(lines) == 1, lines
    out = json.loads(lines[0])
    assert set(out) == KEYS
    assert out["metric"] == "dynamic_removal_ms_per_frame"
    assert out["unit"] == "ms/frame"
    assert out["device"] == "cpu"
    assert out["value"] > 0


def test_vs_baseline_is_the_baseline_over_the_value(tiny_run):
    out = json.loads(tiny_run.stdout)
    # both printed numbers are rounded to 3 decimals
    slack = 5e-4 + bench.BASELINE_MS * 5e-4 / (out["value"] - 5e-4) ** 2
    assert abs(out["vs_baseline"] - bench.BASELINE_MS / out["value"]) \
        <= slack
    assert bench.BASELINE_MS == 213.67


def test_stderr_carries_every_section(tiny_run):
    err = tiny_run.stderr.splitlines()
    for prefix in PREFIXES:
        assert any(line.startswith(prefix) for line in err), prefix
    for name in ("patchwork", "segment", "recognize", "tracking"):
        assert any(line.startswith(f"[trace] {name}") for line in err), name
        assert any(line.startswith(f"[roofline] {name}") for line in err)
    assert any(line.startswith("[roofline] gicp pair") for line in err)
    assert sum(line.startswith("[engine-trace]") for line in err) == 3
    # the CPU run states no device number
    for line in err:
        if line.startswith(("[trace]", "[engine-trace]")):
            assert "not measured (cpu)" in line, line
    kernels = next(line for line in err if line.startswith("[kernels]"))
    counts = json.loads(kernels[kernels.index("{"):])
    assert set(counts) == SECTIONS
    assert all(n == 0 for n in counts.values())   # no kernel on the CPU


def test_bench_module_catches_nothing():
    """No section of the port's bench swallows its failure."""
    tree = ast.parse(PORT_BENCH.read_text())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def test_a_failing_section_ends_the_run_without_a_headline():
    """The odometry section made to raise: the run exits non-zero after the
    sections before it, with nothing on stdout."""
    code = ("from dr_using_scv_od_tpu_torch.models import odometry\n"
            "def boom(*a, **k):\n"
            "    raise RuntimeError('injected odometry failure')\n"
            "odometry.estimate_window_poses = boom\n"
            "import sys\n"
            "from dr_using_scv_od_tpu_torch.tools import bench\n"
            f"sys.exit(bench.main({TINY!r}))\n")
    proc = _run(code)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "injected odometry failure" in proc.stderr
    assert "[trace]" in proc.stderr      # the sections before it ran


def test_engine_trace_refuses_a_written_snapshot(monkeypatch):
    """A traced engine call that writes into the snapshot's tensors ends
    the engine-trace section with an error (the port's window step writes
    into copies, so the snapshot must stay as it was)."""
    cfg, ec = config.tiny_test(), bench.slam_config()
    W = ec.window
    win = synthetic.render_window(synthetic.make_scene(bench.slam_spec()),
                                  2 * W - 1, cfg.shapes.max_points)
    scans = [torch.as_tensor(win[k]) for k in ("xyz", "intensity", "valid")]
    eng = engine.SlamEngine(cfg, ec, device="cpu")
    for f in range(W):
        eng.feed(*(t[f] for t in scans))
    state = eng.state
    before = [t.clone() for t in engine.state_leaves(state)]
    run_pgo = engine._run_pgo

    def writes(st, n, ec):
        st.poses.add_(1.0)
        return run_pgo(st, n, ec)

    monkeypatch.setattr(engine, "_run_pgo", writes)
    window = [t[W - 1:2 * W - 1] for t in scans]
    with pytest.raises(RuntimeError, match="wrote into the snapshot"):
        bench.engine_step_parts(state, before, *window, ec, cfg,
                                torch.device("cpu"))


def test_cuda_without_a_card_fails_before_any_work(monkeypatch):
    def no_work(*a, **k):
        raise AssertionError("the bench did work without its device")

    monkeypatch.setattr(synthetic, "render_window", no_work)
    monkeypatch.setattr(pipeline, "run_window", no_work)
    with pytest.raises(RuntimeError, match="not available"):
        bench.main(["--device", "cuda"])
    proc = _run([], timeout=120)          # the default device: the card
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "[device]" not in proc.stderr


def _call_keywords(tree, func_name):
    """Keywords of the one call of `<...>.func_name(...)` in the tree."""
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute)
             and n.func.attr == func_name]
    assert len(calls) == 1, func_name
    return {k.arg: k.value for k in calls[0].keywords}


def _assigned(tree, name):
    values = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
              and any(isinstance(t, ast.Name) and t.id == name
                      for t in n.targets)]
    assert len(values) == 1, name
    return ast.literal_eval(values[0])


def test_slam_scene_and_engine_config_are_bench_pys():
    """The [slam] scene and EngineConfig of the port's bench equal those of
    bench.py:309-329 field by field, read from its source, and so do the
    constants that size the run."""
    tree = ast.parse(JAX_BENCH.read_text())
    spec_kw = {k: ast.literal_eval(v)
               for k, v in _call_keywords(tree, "SceneSpec").items()}
    want_spec = dataclasses.asdict(jsynthetic.SceneSpec(**spec_kw))
    assert dataclasses.asdict(bench.slam_spec()) == want_spec

    ec_kw = _call_keywords(tree, "EngineConfig")
    erasor_call = ec_kw.pop("erasor")
    assert ast.unparse(erasor_call.args[0]).endswith("ErasorConfig()")
    erasor_kw = {k.arg: ast.literal_eval(k.value)
                 for k in erasor_call.keywords}
    want_ec = jengine.EngineConfig(
        **{k: ast.literal_eval(v) for k, v in ec_kw.items()},
        erasor=dataclasses.replace(jengine.erasor_mod.ErasorConfig(),
                                   **erasor_kw))
    assert dataclasses.asdict(bench.slam_config()) \
        == dataclasses.asdict(want_ec)

    assert _assigned(tree, "REPS") == bench.REPS
    assert _assigned(tree, "BASELINE_MS") == bench.BASELINE_MS
    assert _assigned(tree, "F") == bench.F
    assert _assigned(tree, "Fs") == bench.SLAM_FRAMES
    assert _assigned(tree, "PIPE_FROM") == bench.PIPE_FROM
