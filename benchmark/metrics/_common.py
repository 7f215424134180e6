"""Arithmetic that several per-layer metrics share (not a metric)."""

from __future__ import annotations

from typing import Any, Dict, Optional


def idle_pct(ctx: Dict[str, Any]) -> Optional[float]:
    """The share of the served path's wall time in which no device
    operation ran: 1 - busy / wall, per frame. Busy is the device time of
    the profiled stretch (the union of its kernels, copies and fills); wall
    is the host clock over the same work run again with no profiler
    (`wall_s` over `wall_frames`), since the profiler slows the host's
    launches and would count its own cost as idle time."""
    tr = ctx["trace"]
    if not tr.ops or ctx.get("wall_s", 0.0) <= 0:
        return None
    busy = tr.busy_s / ctx["profiled_frames"]
    return 100.0 * (1.0 - busy / (ctx["wall_s"] / ctx["wall_frames"]))


def launches_per_frame(ctx: Dict[str, Any]) -> Optional[float]:
    """CUDA kernels launched in the profiled stretch, per frame."""
    n = len(ctx["trace"].kernels)
    return n / ctx["profiled_frames"] if n else None


def device_ms_per_frame(ctx: Dict[str, Any], pattern: str
                        ) -> Optional[float]:
    """Device ms, per profiled frame, of the kernels whose name holds
    `pattern`."""
    s = ctx["trace"].device_s(lambda name: pattern in name)
    return s * 1e3 / ctx["profiled_frames"] if s > 0 else None


def span_ms_per_frame(ctx: Dict[str, Any], *spans: str,
                      self_spans: tuple = ()) -> Optional[float]:
    """ms per frame of the spans `spans` (whole) and
    `self_spans` (less their nested spans); None where none of them ran."""
    got = [ctx["span_s"][s] for s in spans if s in ctx["span_s"]]
    if not got:
        return None
    got += [ctx.get("span_self_s", {}).get(s, 0.0) for s in self_spans]
    return sum(got) * 1e3 / ctx["span_frames"]
