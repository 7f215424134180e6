"""The port's own record of a traced run: the spans it opens at its stage
boundaries and the host-device synchronisations it makes
(`dr_using_scv_od_tpu_torch/utils/timing.recording`), and the arithmetic
the metrics that read it share.

The runner hands a metric the traced run's context alone, and the drivers
make no record. So the first metric that reads a record runs the cell's
own pass once more, after the traced stretch and the check: the driver's
`short(state)` (one pool pass, or one session), taken with the driver's
state from the runner's frame (`run_cell`). It keeps the record in the
context, where the other metrics find it:
  program_record       one pass under the profiler in `recording()`:
                       spans on the host clock (perf_counter_ns) and, on a
                       card, the syncs counted; its trace is
                       `program_trace`, and the trace's clock less the
                       host's `program_offset`;
  program_sync_record  one pass in `recording(sync=True)`: each span's
                       time is the device work it launched. On a card it
                       counts the same syncs: the recorder's own are not
                       counted.
Both passes run what the driver's passes run, so they have its frames
(`profiled_frames`, `span_frames`). A port without the recorder records
nothing and no pass runs: every metric that reads a record then finds
nothing to read.
"""

from __future__ import annotations

import bisect
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from benchmark import harness


def _recorder():
    """The port's `timing.recording`, or None where the port has none."""
    from dr_using_scv_od_tpu_torch.utils import timing
    return getattr(timing, "recording", None)


def _runner() -> Optional[Tuple[Any, Any]]:
    """(driver module, driver state) of the `run_cell` that reads the
    metrics, or None outside one."""
    f = sys._getframe(1)
    while f is not None:
        loc = f.f_locals
        if f.f_code.co_name == "run_cell" and {"driver", "state"} <= set(loc):
            return loc["driver"], loc["state"]
        f = f.f_back
    return None


def _offset(trace, launched_ns: int) -> Optional[int]:
    """The trace's clock less the host's, from the marker kernel launched
    at `launched_ns` once the device was idle: the last operation of the
    trace. A second profiled stretch in a process can lose its first few
    operations, the harness's marker at its start among them, so the
    marker is put at the end."""
    last = max(trace.ops, key=lambda o: o[1], default=None)
    if last is None or harness.MARKER not in last[0]:
        return None
    return last[1] - launched_ns


def profiled(ctx: Dict[str, Any]):
    """The record of one profiled pass in `recording()`, made at the first
    call (its trace and clock offset go to `ctx["program_trace"]` and
    `ctx["program_offset"]`); None where the port has no recorder or no
    runner is found."""
    if "program_record" not in ctx:
        ctx["program_record"] = ctx["program_trace"] = None
        ctx["program_offset"] = None
        recording, run = _recorder(), _runner()
        if recording is not None and run is not None:
            driver, state = run
            launched: List[int] = []

            def marked():
                driver.short(state)
                harness.sync(state.device)
                launched.append(time.perf_counter_ns())
                if state.device.type == "cuda":
                    import torch
                    torch.cuda._sleep(1000)

            with recording() as rec:
                _, trace = harness.profile(marked, state.device)
            ctx["program_record"], ctx["program_trace"] = rec, trace
            ctx["program_offset"] = _offset(trace, launched[0])
    return ctx["program_record"]


def synchronised(ctx: Dict[str, Any]):
    """The record of one pass in `recording(sync=True)`, made at the first
    call; None as for `profiled`."""
    if "program_sync_record" not in ctx:
        ctx["program_sync_record"] = None
        recording, run = _recorder(), _runner()
        if recording is not None and run is not None:
            driver, state = run
            with recording(sync=True) as rec:
                driver.short(state)
            harness.sync(state.device)
            ctx["program_sync_record"] = rec
    return ctx["program_sync_record"]


def syncs_per_frame(rec, frames: int) -> Optional[float]:
    """Synchronisations the port made in the pass of `rec`, per frame; None
    where nothing was counted (no record, or no card)."""
    if rec is None or rec.syncs is None:
        return None
    return rec.syncs.total / frames


def _intervals(rec, name: str) -> List[Tuple[int, int]]:
    return sorted((s, e) for n, s, e, _ in rec.log if n == name)


def span_ms_per_frame(ctx: Dict[str, Any], name: str) -> Optional[float]:
    """ms per frame of the synchronised program spans `name`; None where
    none ran."""
    rec = synchronised(ctx)
    iv = _intervals(rec, name) if rec is not None else []
    if not iv:
        return None
    return sum(e - s for s, e in iv) / 1e6 / ctx["span_frames"]


def device_ms_in_spans(ctx: Dict[str, Any], name: str) -> Optional[float]:
    """Device ms per profiled frame of the kernels whose start, on the host
    clock (the trace's clock less `program_offset`), lies inside a program
    span `name` of the profiled pass; None without the record, without the
    clock marker or where no such span ran."""
    rec = profiled(ctx)
    offset = ctx["program_offset"]
    if rec is None or offset is None:
        return None
    iv = _intervals(rec, name)
    if not iv:
        return None
    starts = [s for s, _ in iv]
    total = 0
    for _, start, dur in ctx["program_trace"].kernels:
        host = start - offset
        i = bisect.bisect_right(starts, host) - 1
        if i >= 0 and host < iv[i][1]:
            total += dur
    return total / 1e6 / ctx["profiled_frames"]
