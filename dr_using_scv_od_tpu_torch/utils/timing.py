"""Stage timing & tracing (counterpart of
dr_using_scv_od_tpu/utils/timing.py).

Analog of the reference's TicToc + tab-separated stage log
(include/tictoc.h:16-65; per-stage ms appended to out/time4.txt at
src/ssc.cpp:250,654,894,1425, plotted by tool/time.py), with a
torch.profiler trace for device-level timelines.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (tuple, list)):      # NamedTuples among them
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    if isinstance(x, dict):
        return _first_tensor(list(x.values()))
    return None


def sync(x) -> None:
    """Wait until the device that holds `x` (a tensor, or the first tensor
    of a nested tuple / list / dict) has finished its queued work. A CPU
    tensor is ready when the call returns, so there is nothing to wait
    for."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class StageTimer:
    """Collects per-stage wall-clock ms; writes a tab-separated log line
    per frame like the reference's `ofs` stream, plus JSON for tooling."""

    def __init__(self, log_path: Optional[str | Path] = None):
        self.log_path = Path(log_path) if log_path else None
        if self.log_path:
            # the reference fsmkdir's every out dir up front (ssc.cpp:41-50)
            self.log_path.parent.mkdir(parents=True, exist_ok=True)
        self.rows: List[Dict[str, float]] = []
        self._current: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            sync(result)
        self._current[name] = (time.perf_counter() - t0) * 1000.0

    def end_frame(self) -> Dict[str, float]:
        row = dict(self._current)
        self.rows.append(row)
        self._current = {}
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write("\t".join(f"{v:.2f}" for v in row.values()) + "\n")
        return row

    def summary(self) -> Dict[str, float]:
        if not self.rows:
            return {}
        keys = self.rows[0].keys()
        return {k: float(np.mean([r.get(k, 0.0) for r in self.rows]))
                for k in keys}

    def dump_json(self, path: str | Path) -> None:
        with open(path, "w") as f:
            json.dump({"rows": self.rows, "summary": self.summary()}, f,
                      indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str | Path):
    """A torch.profiler trace of the block (host and, where a card is
    present, CUDA activity); writes `trace.json`, a Chrome trace, into
    `log_dir`."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
