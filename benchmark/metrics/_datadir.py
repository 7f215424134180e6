"""Readings of the record the `slam_datadir` driver makes of its
unprofiled session in the port's `timing.recording()` (`stream_record`
in the context; not a metric). Each returns None where the record is
missing or holds nothing of the scan stream."""

from __future__ import annotations

from typing import Any, Dict, Optional


def span_ms_per_frame(ctx: Dict[str, Any], name: str) -> Optional[float]:
    """ms per frame of the port's spans `name` in the recorded session."""
    rec = ctx.get("stream_record")
    iv = [(s, e) for n, s, e, _ in rec.log if n == name] if rec else []
    if not iv:
        return None
    return sum(e - s for s, e in iv) / 1e6 / ctx["span_frames"]


def count(ctx: Dict[str, Any], name: str) -> int:
    """The recorded session's count `name` (0 where none was kept)."""
    counts = getattr(ctx.get("stream_record"), "counts", None) or {}
    return counts.get(name, 0)
