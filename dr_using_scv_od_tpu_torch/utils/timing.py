"""Stage timing & tracing (counterpart of
dr_using_scv_od_tpu/utils/timing.py).

Analog of the reference's TicToc + tab-separated stage log
(include/tictoc.h:16-65; per-stage ms appended to out/time4.txt at
src/ssc.cpp:250,654,894,1425, plotted by tool/time.py), and an in-memory
recorder of the spans the pipeline and the SLAM engine open at their
stage boundaries, with the host-device synchronisations made inside them.

Recording is off unless a `recording()` block is open. Then `span(name)`
reads one module global and returns one shared no-op context: no clock
read, no allocation, no device call. Inside `recording()` each span's
start and end are read from `time.perf_counter_ns()`, the host clock on
which a profiler trace's marker ties device time to the host, and on a
CUDA machine every synchronising operation that PyTorch's sync debug mode
reports is counted against the innermost open span and the line of the
port that caused it, and `count(name)` adds to the record's named counts
(which path a call took, say). Spans never annotate a profiler trace.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import sys
import time
import warnings
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

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
        """Times the block as stage `name` (and records it as a span of
        that name while a recording is open)."""
        t0 = time.perf_counter()
        with span(name):
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


# ---------------------------------------------------------------------------
# spans and synchronisations

# the directory that holds the port's package: a frame whose file lies in
# the package is the port's, and its site is named relative to this
_ROOT = str(Path(__file__).resolve().parent.parent.parent)
_PORT = str(Path(_ROOT) / "dr_using_scv_od_tpu_torch") + "/"
# the warning PyTorch's sync debug mode gives for a synchronising operation
SYNC_MESSAGE = "called a synchronizing CUDA operation"
NO_SPAN = "-"      # the span key of a sync made while no span was open


@dataclasses.dataclass
class Span:
    """One span of a record: perf_counter_ns start and end (-1 while it is
    open), its depth (0 for a root), its parent's index in `Record.spans`
    (-1 for a root), the id of its root (`window`, which the spans of one
    root share) and the syncs counted while it was the innermost open
    span."""
    name: str
    start_ns: int
    end_ns: int
    depth: int
    parent: int
    window: int
    syncs: int = 0


@dataclasses.dataclass
class SyncCounts:
    """Synchronisations the port caused: their total, by the innermost open
    span's name (NO_SPAN where none was open) and by `file:line` of the
    first frame of the port's code on the stack."""
    total: int = 0
    by_span: collections.Counter[str] = dataclasses.field(
        default_factory=collections.Counter)
    by_site: collections.Counter[str] = dataclasses.field(
        default_factory=collections.Counter)


class Record:
    """What one `recording()` block saw. `spans` in the order they opened;
    `syncs` is None where nothing was counted (no CUDA: there is nothing to
    synchronise); `counts` the named counts `count()` added; `sync` says
    the spans synchronised the device at their edges."""

    def __init__(self, sync: bool, cuda: bool):
        self.sync = sync
        self.cuda = cuda
        self.spans: List[Span] = []
        self.syncs: Optional[SyncCounts] = SyncCounts() if cuda else None
        self.counts: collections.Counter[str] = collections.Counter()
        self._open: List[int] = []          # indices of the open spans
        self._ids = itertools.count()       # ids of roots that name none
        self._own_sync = False

    @property
    def log(self) -> List[Tuple[str, int, int, int]]:
        """(name, start_ns, end_ns, depth) of every closed span."""
        return [(s.name, s.start_ns, s.end_ns, s.depth) for s in self.spans
                if s.end_ns >= 0]

    def _device_sync(self) -> None:
        if self.sync and self.cuda:
            self._own_sync = True
            try:
                torch.cuda.synchronize()
            finally:
                self._own_sync = False

    def _count(self, frame) -> None:
        """Count one synchronisation reported while `frame` ran."""
        if self._own_sync:
            return
        while frame is not None and \
                not frame.f_code.co_filename.startswith(_PORT):
            frame = frame.f_back
        if frame is None:          # none of the port's: its caller's own
            return
        site = f"{frame.f_code.co_filename[len(_ROOT) + 1:]}:" \
               f"{frame.f_lineno}"
        if self._open:
            inner = self.spans[self._open[-1]]
            inner.syncs += 1
            name = inner.name
        else:
            name = NO_SPAN
        self.syncs.total += 1
        self.syncs.by_span[name] += 1
        self.syncs.by_site[site] += 1


class _Open:
    """A span of the open record, entered once."""
    __slots__ = ("rec", "name", "window")

    def __init__(self, rec: Record, name: str, window: Optional[int]):
        self.rec, self.name, self.window = rec, name, window

    def __enter__(self) -> None:
        rec = self.rec
        rec._device_sync()
        if rec._open:
            parent = rec._open[-1]
            window = rec.spans[parent].window
        else:
            parent = -1
            window = next(rec._ids) if self.window is None else self.window
        rec._open.append(len(rec.spans))
        rec.spans.append(Span(self.name, time.perf_counter_ns(), -1,
                              len(rec._open) - 1, parent, window))

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        try:
            rec._device_sync()
        finally:
            rec.spans[rec._open.pop()].end_ns = time.perf_counter_ns()
        return False


_RECORD: Optional[Record] = None       # the open recording, if any
_OFF = contextlib.nullcontext()


def span(name: str, window: Optional[int] = None):
    """A context that records the block as span `name` while a recording
    is open, and does nothing otherwise. A span opened with no other open
    is a root: its id is `window`, or the record's next number where none
    is given; a nested span takes its root's id."""
    rec = _RECORD
    if rec is None:
        return _OFF
    return _Open(rec, name, window)


def count(name: str) -> None:
    """Add one to the open recording's count `name`; nothing while no
    recording is open."""
    rec = _RECORD
    if rec is not None:
        rec.counts[name] += 1


@contextlib.contextmanager
def _counting_syncs(rec: Record) -> Iterator[None]:
    """Turn on PyTorch's sync debug mode and count each synchronisation it
    reports into `rec` instead of showing it; restore the mode and the
    warning filters on the way out."""
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        show = warnings.showwarning

        def counted(message, category, filename, lineno, file=None,
                    line=None):
            if issubclass(category, UserWarning) and \
                    str(message).startswith(SYNC_MESSAGE):
                rec._count(sys._getframe(1))
            else:
                show(message, category, filename, lineno, file, line)

        warnings.showwarning = counted
        warnings.filterwarnings("always", message=SYNC_MESSAGE,
                                category=UserWarning)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def recording(sync: bool = False) -> Iterator[Record]:
    """Record the spans opened in the block, and on a CUDA machine the
    synchronisations the port makes in it; yields the Record. With `sync`
    each span synchronises the device at its start and end, so its time is
    the device work it launched (those synchronisations are not counted).
    One recording at a time."""
    global _RECORD
    if _RECORD is not None:
        raise RuntimeError("a recording is already open")
    rec = Record(sync, torch.cuda.is_available())
    with _counting_syncs(rec) if rec.cuda else contextlib.nullcontext():
        _RECORD = rec
        try:
            yield rec
        finally:
            _RECORD = None
