"""The benchmark loads no JAX: no module a run imports has the top-level
name jax, jaxlib, flax or dr_using_scv_od_tpu (compared whole: the port's
name begins with the JAX package's), and the plain reference imports
nothing of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark import harness

REF = harness.BENCH / "reference"
PORT = "dr_using_scv_od_tpu_torch"

# imports every module under benchmark/ (the tests aside), runs one tiny
# removal session on the CPU, and prints the forbidden modules loaded
_GUARD = r"""
import importlib, json, sys, time
from pathlib import Path
import pytest, torch
sys.path.insert(0, sys.argv[1])
torch.set_num_threads(2)
from benchmark import harness
root = harness.BENCH
for path in sorted(root.rglob("*.py")):
    rel = path.relative_to(root.parent)
    if "tests" in rel.parts:
        continue
    if rel.parts[1] in ("drivers", "metrics") and path.stem != "__init__":
        harness.load_module(rel.parts[1], path.stem)
    else:
        parts = list(rel.with_suffix("").parts)
        if parts[-1] == "__init__":
            parts.pop()
        importlib.import_module(".".join(parts))
from benchmark.tests import tiny
from benchmark import run
mp = pytest.MonkeyPatch()
tiny.make_root(Path(sys.argv[2]), mp)
res = run.run_cell("tiny-removal", 7, 0.2, False, torch.device("cpu"),
                   t_start=time.perf_counter())
print(json.dumps({"forbidden": harness.forbidden_modules(),
                  "port_loaded": "dr_using_scv_od_tpu_torch" in sys.modules,
                  "correct": res["correct"]}))
"""


def test_a_run_imports_no_jax(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", _GUARD, str(harness.ROOT), str(tmp_path)],
        capture_output=True, text=True, timeout=600, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "port_loaded": True, "correct": True}


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dr_using_scv_od_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dr_using_scv_od_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["dr_using_scv_od_tpu.models",
                                           "jax"]


def _imports(path: Path):
    """(top-level name of each absolute import, level and module of each
    relative one) in a source file."""
    absolute, relative = [], []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            absolute += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                absolute.append(node.module.split(".")[0])
            else:
                relative.append((node.level, node.module))
    return absolute, relative


def test_the_reference_imports_nothing_of_the_port():
    allowed = {"__future__", "dataclasses", "functools", "hashlib",
               "itertools", "math", "numpy", "pathlib", "typing", "torch",
               "warnings"}
    files = sorted(REF.rglob("*.py"))
    assert len(files) >= 20
    for path in files:
        absolute, relative = _imports(path)
        assert set(absolute) <= allowed, (path, set(absolute) - allowed)
        depth = len(path.relative_to(REF).parts) - 1   # 0 at reference/
        for level, _ in relative:
            assert level <= depth + 1, (path, level)     # stays inside


def test_the_reference_loads_no_port_module():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import importlib\n"
            "from pathlib import Path\n"
            "ref = Path(sys.argv[1]) / 'benchmark' / 'reference'\n"
            "for p in sorted(ref.rglob('*.py')):\n"
            "    parts = list(p.relative_to(ref.parent.parent)"
            ".with_suffix('').parts)\n"
            "    parts = parts[:-1] if parts[-1] == '__init__' else parts\n"
            "    importlib.import_module('.'.join(parts))\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(harness.ROOT)],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert PORT not in top
    assert not top & harness.FORBIDDEN
