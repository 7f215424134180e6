"""The port's stage profiler (python -m
dr_using_scv_od_tpu_torch.tools.profile_stages) drives each component once
on the CPU at the tiny_test() size, with the device given explicitly. On
the CPU the kernels' wrappers run their plain versions; the timings are
host-clock numbers of no device. The card run is chip_smoke.py's phase 7.
"""

import pytest
import torch

from dr_using_scv_od_tpu_torch import config
from dr_using_scv_od_tpu_torch.tools import profile_stages

# the printed names each component times
NAMES = {
    "quantize": ["quantize+voxel_stats_moments"],
    "cc": ["cc_labels"],
    "ri3": ["ri3_labels"],
    "fused": ["fused cc+ri3 kernel"],
    "compact": ["compact_grid_labels"],
    "segrest": ["segment_frame FULL"],
    "patchwork": ["patchwork FULL"],
    "recog": ["recognize FULL"],
    "track": ["track_window (6 frames)"],
    "gicp": ["gicp build_voxel_map", "gicp finalize_target",
             "gicp 1 GN iter", "gicp register_pyramid pair"],
}


@pytest.mark.parametrize("component", profile_stages.COMPONENTS)
def test_component_runs_on_cpu(component, capsys):
    out = profile_stages.run([component], config.tiny_test(),
                             torch.device("cpu"), reps=1)
    assert list(out) == NAMES[component]
    assert all(ms > 0 for ms in out.values())
    printed = capsys.readouterr().out.splitlines()
    assert [line.split("  ")[0].rstrip() for line in printed] == \
        NAMES[component]


def test_unknown_component_and_missing_device_raise():
    with pytest.raises(ValueError):
        profile_stages.run(["ccrounds"], config.tiny_test(), "cpu")
    with pytest.raises(RuntimeError):
        profile_stages.require_device(
            f"cuda:{torch.cuda.device_count()}")
