"""Structured run logging.

Analog of the reference's ROS console stage summaries (e.g. per-frame
cluster counts at src/ssc.cpp:243, 392, 653, 1424), emitted as both
human-readable lines and machine-readable JSONL for tooling - the
reference's equivalent "observability" was grep-ing rosconsole output
(SURVEY.md section 5).

A copy of dr_using_scv_od_tpu/utils/logging.py (standard library only),
held equal to it by tests/test_torch_io.py."""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

_logger: Optional[logging.Logger] = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        lg = logging.getLogger("dr_using_scv_od_tpu_torch")
        if not lg.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s %(message)s",
                datefmt="%H:%M:%S"))
            lg.addHandler(h)
            lg.setLevel(logging.INFO)
        _logger = lg
    return _logger


class RunLog:
    """Per-run JSONL event stream + console mirror."""

    def __init__(self, path: Optional[str | Path] = None):
        self.path = Path(path) if path else None
        self._fh = open(self.path, "a") if self.path else None
        self.t0 = time.time()

    def event(self, kind: str, **fields: Any) -> Dict[str, Any]:
        row = {"t": round(time.time() - self.t0, 3), "kind": kind, **fields}
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        get_logger().info("%s %s", kind, " ".join(
            f"{k}={v}" for k, v in fields.items()))
        return row

    def frame_summary(self, frame_id: int, n_clusters: int,
                      n_dynamic: int, ms: float) -> None:
        """The reference's per-frame summary line (src/ssc.cpp:1424)."""
        self.event("frame", id=frame_id, clusters=n_clusters,
                   dynamic=n_dynamic, ms=round(ms, 2))

    def close(self) -> None:
        if self._fh:
            self._fh.close()
