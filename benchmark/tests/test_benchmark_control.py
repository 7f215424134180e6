"""The control of `correct`, on the card at each cell's own size: the port's
readings pass every limit of its cell, and the reference put in the port's
place one step below the float32 the configurations state (the cell's
`control`: TF32 matmuls, or the scans rounded to bfloat16 where no matmul
of the path can take TF32) fails at least one. Needs a CUDA card:

    python -m pytest benchmark/tests/test_benchmark_control.py -q -m cuda
"""

from __future__ import annotations

import pytest
import torch

from benchmark import harness

CELLS = ("removal-seq00", "slam-seq00-loop")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_port_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at full width on it")
    device = torch.device("cuda", 0)
    wl = harness.workload(cell)
    driver = harness.load_module("drivers", wl["driver"])
    harness.set_float32_matmul(False)
    state = driver.setup(harness.config_doc(wl["config"]), wl["traffic"],
                         2 ** 31 + 101, device)
    program, control = driver.control(state, wl["control"])
    limits = wl["limits"]
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control
