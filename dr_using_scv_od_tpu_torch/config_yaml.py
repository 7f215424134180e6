"""YAML profile loading.

The reference configures through YAML -> ROS param server
(launch/run_semantickitti.launch:5-6, config/semantickitti.yaml). Here the
same YAML schema (both the reference's `ssc/...` key names and this
framework's nested dataclass field names) loads onto the frozen dataclass
profiles, so a reference config file drops in directly.

A copy of dr_using_scv_od_tpu/config_yaml.py that builds this package's
`config` dataclasses; tests/test_torch_io.py holds every `configs/*.yaml`
equal across the two.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict

import yaml

from . import config as config_mod

# reference key -> (section, field) in PipelineConfig
_REF_KEYS = {
    "sensor_height_": ("patchwork", "sensor_height"),
    "min_dis_": ("grid", "min_dis"),
    "max_dis_": ("grid", "max_dis"),
    "min_angle_": ("grid", "min_angle"),
    "max_angle_": ("grid", "max_angle"),
    "min_azimuth_": ("grid", "min_azimuth"),
    "max_azimuth_": ("grid", "max_azimuth"),
    "range_res_": ("grid", "range_res"),
    "sector_res_": ("grid", "sector_res"),
    "azimuth_res_": ("grid", "azimuth_res"),
    "refine_height_": ("seg", "refine_height"),
    "max_z_": ("recog", "max_z"),
    "min_z_": ("recog", "min_z"),
    "car_square_": ("recog", "car_square"),
    "iteration_": ("seg", "iteration"),
    "toBeClass_": ("seg", "to_be_class"),
    "search_c_": ("seg", "search_c"),
    "intensity_diff_": ("seg", "intensity_diff"),
    "intensity_cov_": ("seg", "intensity_cov"),
    "occupancy_": ("track", "occupancy"),
    "max_intensity_": (None, "max_intensity"),
    "skip_": (None, "skip"),
    "dynamic_label_": (None, "dynamic_labels"),
}

# Reference keys accepted for drop-in compatibility but ignored: the
# reference declares them (utility.h:296-297) and never reads them either.
_IGNORED_REF_KEYS = frozenset({"car_angle_", "car_height_"})


def load(path: str | Path,
         base: config_mod.PipelineConfig | None = None
         ) -> config_mod.PipelineConfig:
    """Load a YAML profile over a base config (default: semantickitti)."""
    cfg = base or config_mod.semantickitti()
    with open(path) as f:
        doc = yaml.safe_load(f) or {}

    flat: Dict[str, Any] = {}
    for section in ("common", "ssc", "session", "feature"):
        for k, v in (doc.get(section) or {}).items():
            flat[k] = v
    # also allow our own nested style: {grid: {...}, seg: {...}, ...}
    sections: Dict[str, Dict[str, Any]] = {}
    top: Dict[str, Any] = {}

    for k, v in flat.items():
        if k in _REF_KEYS:
            sec, field = _REF_KEYS[k]
            if isinstance(v, list):
                v = tuple(v)
            if sec is None:
                top[field] = v
            else:
                sections.setdefault(sec, {})[field] = v

    for sec in ("grid", "patchwork", "seg", "recog", "track", "gicp",
                "shapes"):
        nested = doc.get(sec)
        if isinstance(nested, dict):
            sections.setdefault(sec, {}).update(nested)

    for sec, fields in sections.items():
        cur = getattr(cfg, sec)
        cfg = dataclasses.replace(cfg, **{sec: dataclasses.replace(
            cur, **fields)})
    if top:
        cfg = dataclasses.replace(cfg, **top)
    return cfg
