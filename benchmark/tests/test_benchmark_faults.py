"""`correct` comes out false when the timed path is broken underneath: a
whole run of each driver at tiny size on the CPU (the harness's look for a
card skipped), with one fault planted in the port each time. The faults a
cell on one chip can have: a step that returns its state unchanged, half
of the batch left out, an answer altered where it is produced. (No cell
exchanges anything between chips.)"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import run
from benchmark.tests import tiny
from dr_using_scv_od_tpu_torch.models import engine, pipeline, tracking


def _stale_pair_step(orig):
    """Tracking's pair step hands on the carry it was given."""
    def step(cur_table, cur_grid, *args):
        out = orig(cur_table, cur_grid, *args)
        counter = args[6]
        return (out[0], cur_table, cur_grid, counter, *out[4:])
    return step


def _half_window(orig):
    """run_window sees the points of the first half of its frames only."""
    def run_window(xyz, intensity, valid, *args, **kwargs):
        valid = valid.clone()
        valid[(valid.shape[0] + 1) // 2:] = False
        return orig(xyz, intensity, valid, *args, **kwargs)
    return run_window


def _flipped_verdicts(orig):
    """run_window's first frame comes out with every verdict inverted."""
    def run_window(xyz, intensity, valid, *args, **kwargs):
        res = orig(xyz, intensity, valid, *args, **kwargs)
        removed = res.removed.clone()
        removed[0] = ~removed[0] & valid[0]
        return res._replace(removed=removed)
    return run_window


def _stale_engine_state(orig):
    """The engine's window step returns the state it was given."""
    def process_window(state, *args, **kwargs):
        _, out = orig(state, *args, **kwargs)
        return state, out
    return process_window


def _half_engine_window(orig):
    """The engine's window step sees the points of half of its scans."""
    def process_window(state, xyz, intensity, valid, *args, **kwargs):
        valid = valid.clone()
        valid[(valid.shape[0] + 1) // 2:] = False
        return orig(state, xyz, intensity, valid, *args, **kwargs)
    return process_window


def _moved_pose(orig):
    """The engine's window step reports its second scan 0.5 m off."""
    def process_window(*args, **kwargs):
        state, out = orig(*args, **kwargs)
        poses = out.poses.clone()
        poses[1, 0, 3] += 0.5
        return state, out._replace(poses=poses)
    return process_window


FAULTS = {
    "removal-state-unchanged": ("tiny-removal", tracking, "_pair_step",
                                _stale_pair_step),
    "removal-half-batch": ("tiny-removal", pipeline, "run_window",
                           _half_window),
    "removal-answer-altered": ("tiny-removal", pipeline, "run_window",
                               _flipped_verdicts),
    "slam-state-unchanged": ("tiny-slam", engine, "process_window",
                             _stale_engine_state),
    "slam-half-batch": ("tiny-slam", engine, "process_window",
                        _half_engine_window),
    "slam-answer-altered": ("tiny-slam", engine, "process_window",
                            _moved_pose),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, tmp_path, monkeypatch):
    cell, module, attr, make = FAULTS[fault]
    tiny.make_root(tmp_path, monkeypatch)
    monkeypatch.setattr(module, attr, make(getattr(module, attr)))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        # long enough for a second window, which a stale state shows in
        res = run.run_cell(cell, 2 ** 32 + 9, 2.0, False,
                           torch.device("cpu"), t_start=time.perf_counter())
    finally:
        torch.set_num_threads(n)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
