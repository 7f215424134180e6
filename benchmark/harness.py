"""What every cell shares: finding a cell's files by name, the result line,
the device block, the spans a traced run records around the port's module
functions, and the reduction of a profiler trace to device time, launches,
idle gaps and a breakdown.

A cell is `benchmark/workloads/<cell>.json`: its configuration (a file of
`benchmark/configs/`), the driver it runs (`benchmark/drivers/<driver>.py`),
its traffic parameters (read by `benchmark/traffic/generator.py`) and the
limits of the numbers that decide `correct`. A per-layer metric is
`benchmark/metrics/<metric>.py`, whose `read(ctx)` returns the metric's
value from a traced run's context, or None where it finds nothing to
read. Nothing here lists cells, configurations, drivers or metrics: the
runner loads each by the name that BENCHMARK.json and the cell's file give.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import importlib.util
import json
import re
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent     # the checkout's root
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# top-level module names no run may hold once its window has closed; the
# port's name begins with the JAX package's, so names compare whole
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "dr_using_scv_od_tpu"})
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _named(kind: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = BENCH / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    return path


def benchmark_spec() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> Dict[str, Any]:
    return load_json(_named("workloads", name, ".json"))


def config_doc(name: str) -> Dict[str, Any]:
    return load_json(_named("configs", name, ".json"))


def load_module(kind: str, name: str):
    """`benchmark/<kind>/<name>.py` as a module (names may hold dots and
    dashes, so it is loaded from its path)."""
    path = _named(kind, name, ".py")
    mod_name = f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_entry(spec: Dict[str, Any], cell: str) -> Dict[str, Any]:
    for w in spec["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {cell!r}")


def end_to_end_names(spec: Dict[str, Any], cell: str) -> List[str]:
    return [m["name"] for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_names(spec: Dict[str, Any], cell: str) -> List[str]:
    """The per-layer metrics of `cell`: those that list it, and those with
    no list whose end-to-end metric the cell reports."""
    e2e = set(end_to_end_names(spec, cell))
    return [m["name"] for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def units(spec: Dict[str, Any]) -> Dict[str, str]:
    return {m["name"]: m["unit"] for m in spec["end_to_end"]
            + spec["per_layer"]}


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name (the part before
    the first dot, compared whole) is in FORBIDDEN."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# configurations


def port_configs(doc: Dict[str, Any]):
    """(PipelineConfig, EngineConfig or None) of the port, built from the
    configuration file with the reference's builder (every field given)."""
    from dr_using_scv_od_tpu_torch import config as port_config
    from dr_using_scv_od_tpu_torch.models import engine as port_engine
    from .reference.build import build_dataclass
    cfg = build_dataclass(port_config.PipelineConfig(), doc["pipeline"])
    ec = (None if doc.get("engine") is None
          else build_dataclass(port_engine.EngineConfig(), doc["engine"]))
    return cfg, ec


def set_float32_matmul(tf32: bool) -> None:
    """The configurations state float32 with TF32 off."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


# The controls of `correct`: the reference put in the port's place and run
# one step below the precision a configuration states (float32, TF32 off):
#   "tf32"  float32 matmuls in TF32;
#   "bf16"  the scans' coordinates and intensities rounded to bfloat16
#           (the float32 arithmetic kept), as a port that held the scans in
#           bfloat16 would compute.
CONTROLS = ("tf32", "bf16")


@contextlib.contextmanager
def lower(control: str):
    if control and control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    set_float32_matmul(control == "tf32")
    try:
        yield
    finally:
        set_float32_matmul(False)


def lower_input(control: str, t):
    import torch
    if control == "bf16":
        return t.to(torch.bfloat16).to(t.dtype)
    return t


# ---------------------------------------------------------------------------
# the device


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_block(device, count: int) -> Dict[str, Any]:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                device))}


# ---------------------------------------------------------------------------
# spans around the port's module functions


class Spans:
    """Wraps named module functions for the length of a `with` block. Each
    call is timed on the host clock; with `record` it is also named in a
    profiler trace by a `torch.profiler.record_function` of the span's
    name. With `sync` the device is synchronised before and after each
    call, so a span's time is the work it launched; without, the spans only
    say what the host was doing (`log` holds every call's (name, start_ns,
    end_ns, depth)), at the cost of two clock reads a call."""

    def __init__(self, device, sync_calls: bool,
                 targets: List[Tuple[Any, str, str]], record: bool = True):
        self.device = device
        self.sync_calls = sync_calls
        self.targets = targets
        self.record = record
        self.seconds: Dict[str, float] = {}
        self.self_seconds: Dict[str, float] = {}    # less nested spans
        self.log: List[Tuple[str, int, int, int]] = []
        self._saved: List[Tuple[Any, str, Any]] = []
        self._depth = 0
        self._child = [0]     # nested span ns of each open span

    def _wrap(self, fn: Callable, name: str) -> Callable:
        import torch

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if self.sync_calls:
                sync(self.device)
            depth = self._depth
            self._depth += 1
            self._child.append(0)
            t0 = time.perf_counter_ns()
            try:
                if self.record:
                    with torch.profiler.record_function(name):
                        out = fn(*args, **kwargs)
                else:
                    out = fn(*args, **kwargs)
                if self.sync_calls:
                    sync(self.device)
            finally:
                self._depth -= 1
                child = self._child.pop()
            t1 = time.perf_counter_ns()
            self._child[-1] += t1 - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + (t1 - t0) / 1e9
            self.self_seconds[name] = (self.self_seconds.get(name, 0.0)
                                       + (t1 - t0 - child) / 1e9)
            self.log.append((name, t0, t1, depth))
            return out
        return spanned

    def __enter__(self) -> "Spans":
        for module, attr, name in self.targets:
            fn = getattr(module, attr)
            self._saved.append((module, attr, fn))
            setattr(module, attr, self._wrap(fn, name))
        return self

    def __exit__(self, *exc) -> None:
        for module, attr, fn in reversed(self._saved):
            setattr(module, attr, fn)
        self._saved.clear()


# ---------------------------------------------------------------------------
# the profiler trace


MARKER = "spin_kernel"    # torch.cuda._sleep's kernel, launched at t0


@dataclasses.dataclass
class Trace:
    """Device operations of a profiled stretch, on the trace's clock (ns):
    (name, start, duration) of every kernel, copy and fill."""
    ops: List[Tuple[str, int, int]]
    host_t0: int              # perf_counter_ns at the stretch's start
    host_t1: int              # ... and at its end, after a synchronise
    offset: Optional[int]     # trace clock minus perf_counter_ns

    @property
    def window_s(self) -> float:
        return (self.host_t1 - self.host_t0) / 1e9

    @functools.cached_property
    def kernels(self) -> List[Tuple[str, int, int]]:
        """The kernels: every operation but copies, fills and the marker."""
        return [o for o in self.ops if not o[0].startswith(("Memcpy",
                                                            "Memset"))
                and MARKER not in o[0]]

    @functools.cached_property
    def intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, sorted."""
        merged: List[List[int]] = []
        for name, s, d in sorted(self.ops, key=lambda o: o[1]):
            if MARKER in name:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], s + d)
            else:
                merged.append([s, s + d])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals) / 1e9

    def device_s(self, match: Callable[[str], bool]) -> float:
        return sum(d for n, _, d in self.kernels if match(n)) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        """Idle stretches (start, end) on the trace clock: before the first
        operation, between operations and after the last, inside the
        window where the clock offset is known."""
        iv = self.intervals
        if not iv:
            return []
        edges = []
        if self.offset is not None:
            edges.append((self.host_t0 + self.offset, iv[0][0]))
        edges += [(a[1], b[0]) for a, b in zip(iv, iv[1:])]
        if self.offset is not None:
            edges.append((iv[-1][1], self.host_t1 + self.offset))
        return [(a, b) for a, b in edges if b > a]


def timed(fn: Callable[[], Any], device) -> Tuple[Any, float]:
    """fn()'s result and its wall seconds on the host clock, the device
    synchronised at both ends."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def profile(fn: Callable[[], Any], device) -> Tuple[Any, Trace]:
    """Run fn() under torch.profiler (device activity only) and return its
    result and the trace. A marker kernel launched right after the start
    ties the trace's clock to the host's; the stretch ends with a
    synchronise. On the CPU there is no device trace: ops stay empty."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = ([ProfilerActivity.CUDA] if device.type == "cuda"
            else [ProfilerActivity.CPU])
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        host_t0 = time.perf_counter_ns()
        if device.type == "cuda":
            torch.cuda._sleep(1000)
        out = fn()
        sync(device)
        host_t1 = time.perf_counter_ns()
    ops: List[Tuple[str, int, int]] = []
    offset = None
    if device.type == "cuda":
        from torch.autograd import DeviceType
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                ops.append((e.name(), e.start_ns(), e.duration_ns()))
        marks = [s for n, s, _ in ops if MARKER in n]
        if marks:
            offset = min(marks) - host_t0
    return out, Trace(ops=ops, host_t0=host_t0, host_t1=host_t1,
                      offset=offset)


def short_name(kernel: str) -> str:
    """A CUDA kernel's function name without namespaces, template arguments
    and parameters (the port's tools/kernel_times.short_name, which keeps
    named namespaces)."""
    name = kernel.replace("(anonymous namespace)::", "").split("(")[0]
    words = name.split("<")[0].split()
    return words[-1].split("::")[-1] if words else kernel


def breakdown(trace: Trace, spans: Optional[Spans]) -> Dict[str, Any]:
    """The ten device operations that took most time (summed by short
    name), and idle time summed by what the host was doing: the innermost
    unsynchronised span open at the middle of each gap ("driver" where no
    span was open, "unaligned" without the clock marker)."""
    by_op: Dict[str, float] = {}
    for n, _, d in trace.kernels:
        k = short_name(n)
        by_op[k] = by_op.get(k, 0.0) + d / 1e9
    idle: Dict[str, float] = {}
    log = sorted(spans.log, key=lambda r: r[1]) if spans else []
    starts = [r[1] for r in log]
    for a, b in trace.gaps():
        name = "unaligned"
        if trace.offset is not None:
            mid = (a + b) // 2 - trace.offset
            name, depth = "driver", -1
            for r in log[:bisect.bisect_right(starts, mid)]:
                if r[1] <= mid < r[2] and r[3] > depth:
                    name, depth = r[0], r[3]
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(idle)}


# ---------------------------------------------------------------------------
# the result


def checks_block(checks: Dict[str, Tuple[float, float]]
                 ) -> Dict[str, Dict[str, float]]:
    return {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}


def passes(checks: Dict[str, Tuple[float, float]]) -> bool:
    return all(v <= lim for v, lim in checks.values())


@contextlib.contextmanager
def stage(label: str):
    """Prints `label` and its seconds on stderr (not part of any metric)."""
    t0 = time.perf_counter()
    yield
    print(f"[bench] {label}: {time.perf_counter() - t0:.3f} s",
          file=sys.stderr, flush=True)
