"""The port's stage profiler (python -m
dr_using_scv_od_tpu_torch.tools.profile_stages) drives each component once
on the CPU at the tiny_test() size, with the device given explicitly. On
the CPU the kernels' wrappers run their plain versions; the timings are
host-clock numbers of no device. The card runs are chip_smoke.py's phases
7 and 14.
"""

import pytest
import torch

from dr_using_scv_od_tpu_torch import config
from dr_using_scv_od_tpu_torch.tools import profile_stages

# the printed names each component times
NAMES = {
    "quantize": ["quantize+voxel_stats"],
    "cc": ["cc_labels"],
    "ri3": ["ri3_labels"],
    "fused": ["fused cc+ri3 kernel"],
    "widestats": ["quantize+voxel_stats_moments"],
    "compact2": ["compact_grid_labels"],
    "compact": ["compact+grid"],
    "segrest": ["segment_frame FULL"],
    "patchwork": ["patchwork FULL", "  patch_id",
                  "  z-histogram [N,256] segment_sum",
                  "  one plane-fit [N,10] segment_sum"],
    "segparts": ["  planarity_from_moments",
                 "  hist_multi (nvox/npts/nplanar) [bincount]",
                 "  bbox minmax fused", "  rank in compact [searchsorted]",
                 "  cumsum [G]"],
    "recog": ["recognize FULL", "  voxel_planarity"],
    "track": ["track_window (6 frames)"],
    "compactparts": ["  cumsum(G)", "  gather cid[root] (G)",
                     "  scatter roots", "  point gather (N from G)"],
    "recogparts": ["  planar gather+segcount", "  feature math"],
    "segparts2": ["  bbox seg min/max/count",
                  "  grid_label_counts [bincount]"],
    "trackparts": ["  budget compaction [searchsorted]", "  warp+quantize(K)",
                   "  dedup sort(K)", "  dedup+cont [bincount]",
                   "  nvox over G [bincount]", "  _pair_step FULL"],
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
    assert [line[:len(name)] for line, name in
            zip(printed, NAMES[component])] == NAMES[component]
    assert len(printed) == len(NAMES[component])


def test_unknown_component_and_missing_device_raise():
    """ccrounds (the TPU kernels' round caps) has no counterpart."""
    with pytest.raises(ValueError):
        profile_stages.run(["ccrounds"], config.tiny_test(), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        profile_stages.run(["segrest"], config.tiny_test(), "cpu",
                           split=True)
    with pytest.raises(RuntimeError):
        profile_stages.require_device(
            f"cuda:{torch.cuda.device_count()}")
