"""The metrics that read the port's own record (benchmark/program_record.py)
on the CPU: each reader on a hand-made record and trace, and tiny traced
runs of each driver, which carry the span metrics and no sync metric (the
CPU counts none), and which read nothing of the record and do not fail
against a port without the recorder."""

from __future__ import annotations

import time
import types

import pytest
import torch

from benchmark import harness, program_record, run
from benchmark.tests import tiny
from dr_using_scv_od_tpu_torch.utils import timing

CPU = torch.device("cpu")


def _record(log, syncs=None):
    return types.SimpleNamespace(
        log=log, syncs=None if syncs is None
        else types.SimpleNamespace(total=syncs))


def _ctx(**kw):
    t0 = 1_000_000
    ops = [(harness.MARKER, t0, 100),
           ("gicp_kernel", t0 + 1_000, 500),         # in odometry 1
           ("memcpy_like_kernel", t0 + 5_000, 300),  # between the spans
           ("gicp_kernel", t0 + 9_000, 700),         # in odometry 2
           ("late_kernel", t0 + 20_000, 900)]        # after both
    ctx = {"program_trace": harness.Trace(ops=ops, host_t0=0,
                                          host_t1=30_000, offset=t0),
           "program_offset": t0, "profiled_frames": 2, "span_frames": 4}
    ctx.update(kw)
    return ctx


def read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


def test_sync_counts_per_frame():
    ctx = _ctx(program_record=_record([], syncs=30),
               program_sync_record=_record([], syncs=36))
    assert read("removal.host_syncs_per_frame", ctx) == 9.0   # span_frames
    assert read("slam.host_syncs_per_frame", ctx) == 15.0
    # not counted (no card) or no recorder: nothing to read
    for rec in (_record([]), None):
        assert read("slam.host_syncs_per_frame",
                    _ctx(program_record=rec)) is None


def test_device_time_inside_program_spans():
    log = [("window", 0, 15_000, 0), ("odometry", 500, 2_000, 1),
           ("odometry", 8_000, 12_000, 1), ("loops", 12_000, 14_000, 1)]
    ctx = _ctx(program_record=_record(log))
    got = read("slam.odometry_device_ms_per_frame", ctx)
    assert got == pytest.approx((500 + 700) / 1e6 / 2)
    assert program_record.device_ms_in_spans(ctx, "pgo") is None
    unaligned = _ctx(program_record=_record(log))
    unaligned["program_offset"] = None
    assert read("slam.odometry_device_ms_per_frame", unaligned) is None


def test_the_clock_offset_comes_from_the_marker_at_the_end():
    def trace(*ops):
        return harness.Trace(ops=list(ops), host_t0=0, host_t1=0,
                             offset=None)

    # the start's marker and first kernels lost, as a second profiled
    # stretch in a process can lose them: the end's marker still serves
    got = program_record._offset(trace(("k", 5_000, 10),
                                       (harness.MARKER, 9_000, 100),
                                       ("k", 7_000, 10)), 400)
    assert got == 8_600
    assert program_record._offset(trace(("k", 5_000, 10)), 400) is None
    assert program_record._offset(trace((harness.MARKER, 1_000, 100),
                                        ("k", 5_000, 10)), 400) is None
    assert program_record._offset(trace(), 400) is None


def test_synchronised_span_times():
    log = [("run_window", 0, 9_000_000, 0),
           ("segmentation", 0, 2_000_000, 2),
           ("recognition", 2_000_000, 2_500_000, 2),
           ("segmentation", 3_000_000, 5_000_000, 2)]
    ctx = _ctx(program_sync_record=_record(log))
    assert read("removal.segmentation_ms_per_frame", ctx) == \
        pytest.approx(1.0)
    assert read("removal.recognition_ms_per_frame", ctx) == \
        pytest.approx(0.125)
    assert read("removal.recognition_ms_per_frame", _ctx()) is None


def test_the_ports_record_has_what_the_readers_read():
    with timing.recording(sync=True) as rec:
        with timing.span("segmentation"):
            pass
    ctx = _ctx(program_sync_record=rec, program_record=rec)
    assert read("removal.segmentation_ms_per_frame", ctx) >= 0
    assert read("removal.host_syncs_per_frame", ctx) is None   # the CPU


def test_no_runner_no_pass():
    ctx = _ctx()
    assert program_record.profiled(ctx) is None
    assert program_record.synchronised(ctx) is None
    assert read("slam.odometry_device_ms_per_frame", ctx) is None


HARNESS_SPANS = {
    "tiny-removal": {"removal.patchwork_ms_per_frame",
                     "removal.tracking_ms_per_frame"},
    "tiny-slam": {"slam.odometry_ms_per_frame", "slam.loops_ms_per_frame"}}
PROGRAM_SPANS = {
    "tiny-removal": {"removal.segmentation_ms_per_frame",
                     "removal.recognition_ms_per_frame"},
    "tiny-slam": set()}


def _tiny_traced(tmp_path, monkeypatch, cell):
    tiny.make_root(tmp_path, monkeypatch)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return run.run_cell(cell, 2 ** 31 + 5, 0.2, True, CPU,
                            t_start=time.perf_counter())
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["tiny-removal", "tiny-slam"])
def test_a_traced_run_carries_the_program_span_metrics(
        tmp_path, monkeypatch, cell):
    made = []
    plain = timing.recording

    def counted(sync=False):
        made.append(sync)
        return plain(sync=sync)

    monkeypatch.setattr(timing, "recording", counted)
    res = _tiny_traced(tmp_path, monkeypatch, cell)
    assert res["correct"] is True
    spans = HARNESS_SPANS[cell] | PROGRAM_SPANS[cell]
    # on the CPU no device trace exists and no sync is counted
    assert spans <= set(res["metrics"]) <= spans | {"slam.pgo_ms_per_frame"}
    assert not any("host_syncs" in m for m in res["metrics"])
    # one extra pass, whichever of the cell's metrics reads it first
    assert made == ([True] if cell == "tiny-removal" else [False])
    assert timing._RECORD is None


@pytest.mark.parametrize("cell", ["tiny-removal", "tiny-slam"])
def test_a_port_without_the_recorder_reads_nothing_of_it(
        tmp_path, monkeypatch, cell):
    monkeypatch.delattr(timing, "recording")
    res = _tiny_traced(tmp_path, monkeypatch, cell)
    assert res["correct"] is True
    spans = HARNESS_SPANS[cell]
    assert spans <= set(res["metrics"]) <= spans | {"slam.pgo_ms_per_frame"}
