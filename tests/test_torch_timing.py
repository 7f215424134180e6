"""The port's span and sync recorder (dr_using_scv_od_tpu_torch/utils/
timing.py) on the CPU at tiny_test() sizes: with no recording open a span
is one shared no-op that reads no clock and arms nothing; a recording
changes no output of `run_window` or of a SlamEngine session, and its
spans nest as the stages do; its log names idle gaps in the benchmark's
`harness.breakdown`; a synchronisation reported inside a span is counted
there and at the port's line that made it; the sync debug mode and the
warning filters come back after an exception. PyTorch's sync debug mode
exists only with CUDA, so the CPU cases stand a fake mode in for it and
report a synchronisation as the mode does (a UserWarning raised during the
op); the `cuda` case counts the card's own."""

from __future__ import annotations

import contextlib
import inspect
import warnings

import numpy as np
import pytest
import torch

from benchmark import harness
from dr_using_scv_od_tpu_torch import config, interop
from dr_using_scv_od_tpu_torch.models import engine, pipeline
from dr_using_scv_od_tpu_torch.ops import clustering, segment_ops
from dr_using_scv_od_tpu_torch.utils import synthetic, timing

CFG = config.tiny_test()
EC = engine.EngineConfig(window=4, max_keyframes=16, submap_points=256,
                         kf_dist=0.5, loop_min_gap=4, loop_min_score=0.5,
                         max_loop_edges=8, pgo_gn_iters=2, pgo_cg_iters=8,
                         erasor_every=2)
FRAMES = 10          # three engine windows; a loop lands in the third
PIPE_FRAMES = 3
CPU = torch.device("cpu")


@contextlib.contextmanager
def _threads(n):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(scope="module")
def win():
    spec = synthetic.SceneSpec(
        trajectory="loop", loop_frames=8, loop_radius=8.0, ground_pts=1500,
        building_pts=300, tree_pts=100, car_pts=120, n_buildings=2,
        n_trees=3, n_parked_cars=2, n_moving_cars=2, extent=14.0,
        moving_speed=4.0)
    return synthetic.render_window(synthetic.make_scene(spec), FRAMES,
                                   CFG.shapes.max_points)


@pytest.fixture(scope="module")
def pipe_inputs(win):
    return interop.window_from_numpy(
        {k: v[:PIPE_FRAMES] for k, v in win.items()}, CPU)


@pytest.fixture(scope="module")
def windows(pipe_inputs):
    """(run_window's result, the same with a recording open, the record)."""
    with _threads(2):
        plain = pipeline.run_window(*pipe_inputs, CFG)
        with timing.recording() as rec:
            recorded = pipeline.run_window(*pipe_inputs, CFG)
    return plain, recorded, rec


def _session(win):
    eng = engine.SlamEngine(CFG, EC, device=CPU)
    for f in range(FRAMES):
        eng.feed(win["xyz"][f], win["intensity"][f], win["valid"][f])
    eng.finalize()
    return eng


@pytest.fixture(scope="module")
def sessions(win):
    """(a SlamEngine session, the same with a recording open, the
    record)."""
    with _threads(2):
        plain = _session(win)
        with timing.recording() as rec:
            recorded = _session(win)
    return plain, recorded, rec


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    return []


def _children(rec, i):
    return [s for s in rec.spans if s.parent == i]


def _roots(rec):
    return [i for i, s in enumerate(rec.spans) if s.parent == -1]


def _check_nesting(rec):
    """Every span closed; a child inside its parent's interval, one level
    deeper, with its root's id."""
    for s in rec.spans:
        assert 0 <= s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
            assert s.depth == p.depth + 1 and s.window == p.window
        else:
            assert s.depth == 0


def test_off_a_span_is_one_shared_noop(monkeypatch, windows, pipe_inputs):
    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"time.{name} read with no recording")

    armed = []
    monkeypatch.setattr(timing, "time", NoClock())
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", armed.append)
    assert timing._RECORD is None
    a, b = timing.span("a"), timing.span("b", window=3)
    assert a is b
    with a:
        with b:
            pass
    with _threads(2):
        res = pipeline.run_window(*pipe_inputs, CFG)
    assert all(torch.equal(x, y) for x, y in
               zip(_leaves(res), _leaves(windows[0])))
    assert armed == []


def test_recording_changes_no_window_output(windows):
    plain, recorded, rec = windows
    a, b = _leaves(plain), _leaves(recorded)
    assert len(a) == len(b) > 10
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # no CUDA: nothing to synchronise, and nothing is counted
    assert (rec.syncs is None) == (not torch.cuda.is_available())


def test_recording_changes_no_session_output(sessions):
    plain, recorded, _ = sessions
    assert plain.windows == recorded.windows == 3
    for x, y in zip(interop.engine_state_to_numpy(plain.state),
                    interop.engine_state_to_numpy(recorded.state)):
        np.testing.assert_array_equal(x, y)
    for o, p in zip(plain.outputs, recorded.outputs):
        for x, y in zip(o, p):
            np.testing.assert_array_equal(x, y)


def test_run_window_span_tree(windows):
    rec = windows[2]
    roots = _roots(rec)
    assert [rec.spans[i].name for i in roots] == ["run_window"]
    assert [s.name for s in _children(rec, roots[0])] == \
        ["patchwork", "segmentation", "recognition"] * PIPE_FRAMES \
        + ["tracking"]
    _check_nesting(rec)


def test_session_span_tree(sessions):
    _, eng, rec = sessions
    roots = _roots(rec)
    assert [rec.spans[i].name for i in roots] == \
        ["window"] * eng.windows + ["finalize"]
    assert [rec.spans[i].window for i in roots[:-1]] == [1, 2, 3]
    for i in roots[:-1]:
        kids = [s.name for s in _children(rec, i)]
        assert kids[:3] == ["odometry", "run_window", "loops"]
        assert kids[3:] in ([], ["pgo"])
        (rw,) = [j for j, s in enumerate(rec.spans)
                 if s.parent == i and s.name == "run_window"]
        names = [s.name for s in _children(rec, rw)]
        assert names.count("segmentation") == names.count("patchwork") > 0
    assert int(eng.state.n_loops) > 0
    assert [s.name for s in _children(rec, roots[-1])] == ["pgo"]
    _check_nesting(rec)


def test_the_log_names_idle_gaps_in_the_breakdown(sessions):
    """harness.breakdown reads the record's log as it reads the harness's
    spans: a gap in the middle of an odometry span is odometry's."""
    rec = sessions[2]
    w = rec.spans[_roots(rec)[0]]
    o = next(s for s in _children(rec, _roots(rec)[0])
             if s.name == "odometry")
    offset = 7_000_000
    a = o.start_ns + (o.end_ns - o.start_ns) // 4
    b = o.start_ns + 3 * (o.end_ns - o.start_ns) // 4
    ops = [(harness.MARKER, w.start_ns + offset, 1),
           ("k1", w.start_ns + offset, a - w.start_ns),
           ("k2", b + offset, w.end_ns - b)]
    trace = harness.Trace(ops=ops, host_t0=w.start_ns, host_t1=w.end_ns,
                          offset=offset)
    bd = harness.breakdown(trace, rec)
    assert bd["idle_gaps"] == [["odometry", (b - a) / 1e9]]


@pytest.fixture
def fake_mode(monkeypatch):
    """A CUDA machine's sync debug mode, on the CPU: `value` is the mode,
    `calls` every mode set."""
    mode = {"value": 0, "calls": []}

    def set_mode(m):
        mode["calls"].append(m)
        mode["value"] = m

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: mode["value"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    return mode


def _line_of(fn, text):
    lines, start = inspect.getsourcelines(fn)
    (i,) = [i for i, line in enumerate(lines) if text in line]
    return start + i


def test_a_sync_is_counted_in_its_span_at_its_site(fake_mode, monkeypatch):
    bincount = torch.bincount

    def syncing(*args, **kwargs):
        warnings.warn(timing.SYNC_MESSAGE)     # as the sync debug mode does
        return bincount(*args, **kwargs)

    monkeypatch.setattr(torch, "bincount", syncing)
    ids, valid = torch.tensor([0, 1, 1, 3]), torch.ones(4, dtype=torch.bool)
    with pytest.warns(UserWarning, match="another") as shown:
        with timing.recording() as rec:
            with timing.span("outer", window=5):
                with timing.span("inner"):
                    segment_ops.segment_count(ids, valid, 4)
                segment_ops.segment_count(ids, valid, 4)
            segment_ops.segment_count(ids, valid, 4)     # no span open
            torch.bincount(ids)             # no frame of the port: not counted
            warnings.warn("another warning")            # shown as before
    site = ("dr_using_scv_od_tpu_torch/ops/segment_ops.py:"
            f"{_line_of(segment_ops.segment_count, 'torch.bincount(')}")
    assert rec.syncs.total == 3
    assert rec.syncs.by_site == {site: 3}
    assert rec.syncs.by_span == {"inner": 1, "outer": 1, timing.NO_SPAN: 1}
    assert [(s.name, s.window, s.syncs) for s in rec.spans] == [
        ("outer", 5, 1), ("inner", 5, 1)]
    assert not any(timing.SYNC_MESSAGE in str(w.message) for w in shown)
    assert fake_mode["calls"] == ["warn", 0]


def test_the_recorders_own_syncs_are_not_counted(fake_mode, monkeypatch):
    waits = []

    def synchronize(device=None):
        waits.append(device)
        warnings.warn(timing.SYNC_MESSAGE)

    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    with timing.recording(sync=True) as rec:
        with timing.span("a"):
            with timing.span("b"):
                pass
    assert len(waits) == 4 and rec.sync
    assert rec.syncs.total == 0


def test_mode_and_filters_come_back_after_an_exception(fake_mode):
    filters, show = list(warnings.filters), warnings.showwarning
    with pytest.raises(ZeroDivisionError):
        with timing.recording() as rec:
            with timing.span("a"):
                1 / 0
    assert warnings.filters == filters and warnings.showwarning is show
    assert fake_mode["value"] == 0 and fake_mode["calls"] == ["warn", 0]
    assert rec.spans[0].end_ns >= rec.spans[0].start_ns
    assert timing._RECORD is None
    with timing.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with timing.recording():
                pass
    assert timing._RECORD is None


def test_named_counts_are_kept_inside_a_recording_only():
    timing.count("a")                     # no recording open: kept nowhere
    assert timing._RECORD is None
    with timing.recording() as first:
        for name in ("a", "b", "a", "a"):
            timing.count(name)
    timing.count("a")
    with timing.recording() as second:
        timing.count("b")
        with pytest.raises(RuntimeError, match="already open"):
            with timing.recording():      # a record inside another: refused
                timing.count("b")         # before its body runs
        timing.count("b")
    assert first.counts == {"a": 3, "b": 1}
    assert second.counts == {"b": 2}


# the kinds of synchronisation, each on a line of its own, compiled under a
# file name of the port's package so that the recorder counts them there
PROBE = """
def probe(x, ids):
    a = x.sum().item()
    b = bool(x.sum() > 0)
    c = int(ids.max())
    d = float(x.sum())
    e = x.cpu()
    f = torch.bincount(ids)
    g = torch.nonzero(ids)
    h = torch.unique(ids)
    i = x + 1
    return a, b, c, d, e, f, g, h, i
"""
PROBE_FILE = "dr_using_scv_od_tpu_torch/models/sync_probe.py"


@pytest.mark.cuda
def test_syncs_on_the_card_are_counted_at_the_callers_line():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: sync debug mode exists only there")
    dev = torch.device("cuda", 0)
    ns = {"torch": torch}
    exec(compile(PROBE, timing._ROOT + "/" + PROBE_FILE, "exec"), ns)
    x = torch.arange(8, dtype=torch.float32, device=dev)
    ids = torch.tensor([0, 1, 1, 3, 0, 2], device=dev)
    occ = torch.zeros((2, 2, 4), dtype=torch.bool, device=dev)
    occ[0, 1, 2] = True
    ns["probe"](x, ids)                       # warm every op first
    before = torch.cuda.get_sync_debug_mode()
    with timing.recording() as rec:
        with timing.span("probe"):
            ns["probe"](x, ids)
        segment_ops.segment_count(ids, ids >= 0, 4)
        clustering.occupied_pairs(occ, clustering.forward_offsets(1))
        torch.cuda.synchronize()              # the caller's own: no frame
        ids.sum().item()                      # of the port on its stack
    assert torch.cuda.get_sync_debug_mode() == before
    by_site = dict(rec.syncs.by_site)
    print("syncs by site:", by_site)
    for line in range(3, 11):                 # a = ... to h = ...
        assert by_site.pop(f"{PROBE_FILE}:{line}", 0) >= 1, line
    assert f"{PROBE_FILE}:11" not in by_site  # x + 1 waits for nothing
    seg = ("dr_using_scv_od_tpu_torch/ops/segment_ops.py:"
           f"{_line_of(segment_ops.segment_count, 'torch.bincount(')}")
    nz = ("dr_using_scv_od_tpu_torch/ops/clustering.py:"
          f"{_line_of(clustering.occupied_pairs, 'torch.nonzero(')}")
    assert by_site.pop(seg) >= 1 and by_site.pop(nz) >= 1
    assert rec.syncs.total == sum(rec.syncs.by_site.values())
    assert rec.syncs.by_span["probe"] >= 8
