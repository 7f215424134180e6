"""Slice parity: the port's run_window against the JAX package's at the
full semantickitti() width (N = 131,072, 60x72x300 grid, C = 512) on the
default synthetic scene with F = 5 - the window tests/test_tracking_e2e.py
holds to the accuracy floors - plus one streaming case whose JAX carry
enters the port through interop.track_carry_from_numpy.

Tolerances:
  * removed, label_grids, n_dynamic and the table's valid / type / state /
    track_id: identical. bbox_min / bbox_max: exact (min and max).
  * point_cluster: identical at every point whose patchwork verdict agrees.
    Patchwork sums patch moments in another order than the JAX package's
    one-hot matmul (see tests/test_torch_ops.py), which flips the ground
    verdict of a few borderline points (37 of 385,006 valid points on this
    window, frames 3 and 4); such a point may then leave or join a cluster.
    The flips are bounded at 0.05 % of the valid points.
The JAX package bounds RI3 to cfg.seg.iteration = 3 rounds on the CPU and
the port runs it to the fixpoint; on this scene the two give the same
labels, which the identical label_grids confirm.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu.models import pipeline as jpipeline
from dr_using_scv_od_tpu_torch import config, interop
from dr_using_scv_od_tpu_torch.eval import metrics
from dr_using_scv_od_tpu_torch.models import pipeline
from dr_using_scv_od_tpu_torch.utils import synthetic

F = 5
F_STREAM = 3
TABLE_FIELDS = ("valid", "type", "state", "track_id", "bbox_min", "bbox_max")


def _jax_window(win, cfg, init_track=None):
    return jpipeline.run_window(
        jnp.asarray(win["xyz"]), jnp.asarray(win["intensity"]),
        jnp.asarray(win["valid"]), jnp.asarray(win["poses"]), cfg,
        init_track=init_track)


def _slice(win, lo, hi):
    return {k: v[lo:hi] for k, v in win.items()}


@pytest.fixture(scope="module")
def windows():
    cfg = config.semantickitti()
    full = synthetic.render_window(synthetic.make_scene(), F + F_STREAM - 1,
                                   cfg.shapes.max_points)
    win = _slice(full, 0, F)
    jres = _jax_window(win, jconfig.semantickitti())
    tres = pipeline.run_window(*interop.window_from_numpy(win, "cpu"), cfg)
    return full, win, jres, tres


def _assert_window_equal(t, j, valid):
    np.testing.assert_array_equal(t.removed.numpy(), np.asarray(j.removed))
    np.testing.assert_array_equal(t.label_grids.numpy(),
                                  np.asarray(j.label_grids))
    np.testing.assert_array_equal(t.n_dynamic.numpy(),
                                  np.asarray(j.n_dynamic))
    for name in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(t.tables, name).numpy(),
                                      np.asarray(getattr(j.tables, name)),
                                      err_msg=name)
    assert int(t.track_counter) == int(j.track_counter)
    # the named patchwork case: ground verdicts that flip on float order
    flipped = (t.frames.state.point_route.numpy()
               != np.asarray(j.frames.state.point_route))
    assert flipped.sum() <= 0.0005 * valid.sum(), int(flipped.sum())
    pc_diff = t.point_cluster.numpy() != np.asarray(j.point_cluster)
    assert not (pc_diff & ~flipped).any(), \
        "point_cluster differs where the patchwork verdicts agree"


def test_run_window_matches_jax(windows):
    _, win, jres, tres = windows
    _assert_window_equal(tres, jres, win["valid"])
    assert int(tres.new_row_overflow) == int(jres.new_row_overflow) == 0


def test_port_meets_accuracy_floors(windows):
    """The floors of tests/test_tracking_e2e.py:47-49 on the port's own
    output (judged frames: the last frame is never a tracking prev)."""
    _, win, _, tres = windows
    m = metrics.removal_metrics(win["label"][:F - 1],
                                tres.removed[:F - 1].numpy(),
                                win["valid"][:F - 1])
    assert m.pr > 99.0, f"static points wrongly removed: PR={m.pr}"
    assert m.rr > 96.0, f"dynamic rejection too low: RR={m.rr}"
    assert m.f1 > 0.97


def test_streaming_carry_from_jax(windows):
    """Window B (frames F-1 .. F+1) continues window A: the JAX run's
    carry (last table, label grid, track counter) seeds both packages."""
    full, _, jres, _ = windows
    win_b = _slice(full, F - 1, F - 1 + F_STREAM)
    last = {f.name: getattr(jres.tables, f.name)[-1]
            for f in dataclasses.fields(jres.tables)}
    carry = (jres.tables.replace(**last), jres.label_grids[-1],
             jres.track_counter)
    jb = _jax_window(win_b, jconfig.semantickitti(), init_track=carry)
    fields = {name: np.asarray(a) for name, a in last.items()}
    init = interop.track_carry_from_numpy(
        fields, np.asarray(jres.label_grids[-1]),
        np.asarray(jres.track_counter), "cpu")
    tb = pipeline.run_window(*interop.window_from_numpy(win_b, "cpu"),
                             config.semantickitti(), init_track=init)
    _assert_window_equal(tb, jb, win_b["valid"])
