"""The port stands alone (no jax, no flax, no import of the JAX package),
and what it copies or carries over from the JAX package is equal to it:
the config profiles, the synthetic scene generator, and the streaming
tracking carry. Tolerance: none (all equalities are exact)."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu.utils import synthetic as jsynthetic
from dr_using_scv_od_tpu_torch import config, interop
from dr_using_scv_od_tpu_torch.utils import synthetic

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "dr_using_scv_od_tpu_torch"
PROFILES = ("semantickitti", "parkinglot", "tiny_test")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax():
    """Every module of the port, and chip_smoke, imported in a fresh
    interpreter, leave jax, flax and the JAX package out of sys.modules."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods] + ["chip_smoke"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'dr_using_scv_od_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_statement(path):
    """No import of jax, flax or the JAX package anywhere in the source,
    including imports inside functions."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in (
                "jax", "jaxlib", "flax", "dr_using_scv_od_tpu"), \
                f"{path.name} imports {name}"


def test_guard_covers_the_entry_points_and_io_modules():
    """The two guards above walk every file of the port: the command line,
    the dataset I/O and the evaluation tools are among them."""
    guarded = {p.relative_to(PORT).as_posix() for p in _port_sources()
               if PORT in p.parents}
    assert {"cli.py", "config_yaml.py", "utils/io_kitti.py",
            "utils/prefetch.py", "utils/io_sydney.py", "utils/logging.py",
            "utils/timing.py", "utils/artifacts.py", "utils/io_session.py",
            "eval/artifact.py", "eval/sweep.py"} <= guarded


@pytest.mark.parametrize("profile", PROFILES)
def test_config_profiles_equal(profile):
    ref = dataclasses.asdict(getattr(jconfig, profile)())
    ported = getattr(config, profile)()
    assert dataclasses.asdict(ported) == ref
    assert interop.config_from_reference(ref) == ported


def test_config_from_reference_rejects_unknown_fields():
    d = dataclasses.asdict(jconfig.semantickitti())
    d["seg"]["not_a_field"] = 1
    with pytest.raises(ValueError):
        interop.config_from_reference(d)


@pytest.mark.parametrize("spec", [
    dict(),
    dict(ground_pts=1200, building_pts=200, tree_pts=80, car_pts=120,
         n_buildings=2, n_trees=2, n_parked_cars=2, n_moving_cars=1,
         extent=14.0, trajectory="loop", wall_parked_cars=1, seed=3),
], ids=["default", "small-loop"])
def test_render_window_equal(spec):
    want = jsynthetic.render_window(
        jsynthetic.make_scene(jsynthetic.SceneSpec(**spec)), 3, 4096)
    got = synthetic.render_window(
        synthetic.make_scene(synthetic.SceneSpec(**spec)), 3, 4096)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_track_carry_from_numpy():
    C, G = 8, 64
    rng = np.random.default_rng(0)
    fields = dict(valid=rng.random(C) < 0.5,
                  n_points=rng.integers(0, 9, C, dtype=np.int32),
                  n_voxels=rng.integers(0, 9, C, dtype=np.int32),
                  bbox_min=rng.normal(size=(C, 3)).astype(np.float32),
                  bbox_max=rng.normal(size=(C, 3)).astype(np.float32),
                  type=rng.integers(-1, 3, C, dtype=np.int32),
                  state=rng.integers(-1, 2, C, dtype=np.int32),
                  track_id=rng.integers(-1, 9, C, dtype=np.int32))
    grid = rng.integers(-1, C, G, dtype=np.int32)
    table, label_grid, counter = interop.track_carry_from_numpy(
        fields, grid, np.int32(7), "cpu")
    for name, want in fields.items():
        got = getattr(table, name)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    assert table.valid.dtype == torch.bool
    assert label_grid.dtype == torch.int32 and counter.shape == ()
    np.testing.assert_array_equal(label_grid.numpy(), grid)
    assert int(counter) == 7
