"""Sydney Urban Objects dataset reader.

Analog of the reference's tool/car.py, which decodes the Sydney dataset's
structured per-object ``.bin`` records (fields t/intensity/id/x/y/z/
azimuth/range/pid, tool/car.py:5-13) for visual inspection. Here the
decode is a library function that feeds the same ``[N, 4]`` xyzi tensors
the rest of the framework consumes, so Sydney objects can be pushed
through the feature/recognition stages directly.

A copy of dr_using_scv_od_tpu/utils/io_sydney.py (numpy only), held equal
to it by tests/test_torch_io.py.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

SYDNEY_DTYPE = np.dtype({
    "names": ["t", "intensity", "id", "x", "y", "z",
              "azimuth", "range", "pid"],
    "formats": ["int64", "uint8", "uint8", "float32", "float32",
                "float32", "float32", "float32", "int32"],
})


def read_sydney_bin(path: str | Path) -> Dict[str, np.ndarray]:
    """Decode one Sydney Urban Objects record file into plain arrays."""
    data = np.fromfile(str(path), dtype=SYDNEY_DTYPE)
    return {
        "xyz": np.stack([data["x"], data["y"], data["z"]], axis=1),
        "intensity": data["intensity"].astype(np.float32),
        "time": data["t"],
        "laser_id": data["id"],
        "azimuth": data["azimuth"],
        "range": data["range"],
        "pid": data["pid"],
    }


def sydney_to_xyzi(path: str | Path) -> np.ndarray:
    """[N, 4] float32 xyzi rows, the framework's canonical scan layout."""
    rec = read_sydney_bin(path)
    return np.concatenate(
        [rec["xyz"].astype(np.float32), rec["intensity"][:, None]], axis=1)
