"""The stopping car and the cluttered scene of tests/test_hard_scenes.py
(F = 6) through the JAX package (RI3 at 24 rounds) and the port at the
full semantickitti() width on the CPU: `removed` identical, the JAX file's
floors held by the port. Tolerances: tests/torch_hard_scenes.
assert_matches_jax (the named patchwork float case).
tests/test_torch_hard_scenes_wall.py holds the wall-parked scene.

Also the fuzzed verdict-lattice scenarios of tests/test_oracle_reference.py
through the JAX tracking._pair_step and the port's: every output
identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_hard_scenes as hs
from test_oracle_reference import _make_scenario

from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu.models import tracking as jtracking
from dr_using_scv_od_tpu_torch import config, interop
from dr_using_scv_od_tpu_torch.models import tracking
from dr_using_scv_od_tpu_torch.types import ClusterTable

TABLE_FIELDS = tuple(ClusterTable.__dataclass_fields__)


@pytest.fixture(scope="module")
def stop():
    return hs.run_both("stop")


@pytest.fixture(scope="module")
def clutter():
    return hs.run_both("clutter")


def test_mover_stopping_mid_window_matches_jax(stop):
    win, jres, res, _ = stop
    hs.assert_matches_jax(win, jres, res)


def test_mover_stopping_mid_window(stop):
    win, _, res, m = stop
    hs.assert_floors("stop", m)
    # the stopped car's parked phase is not removed in bulk
    lab, removed = win["label"], res.removed.numpy()
    late_static_removed = (removed[3:5] & (lab[3:5] == 10)).sum()
    late_static = ((lab[3:5] == 10) & win["valid"][3:5]).sum()
    assert late_static_removed < 0.2 * max(late_static, 1), (
        f"{late_static_removed}/{late_static} parked-phase points removed")


def test_cluttered_scene_matches_jax(clutter):
    win, jres, res, _ = clutter
    hs.assert_matches_jax(win, jres, res)


def test_cluttered_scene_floor(clutter):
    hs.assert_floors("clutter", clutter[3])


@pytest.mark.slow
def test_cluttered_scene_at_three_rounds_parts():
    """The watch-list case (ROADMAP): at the JAX CPU path's default 3 RI3
    rounds the JAX run stops short of the fixpoint on this scene, and its
    removed mask parts from the port's in frame 1 only (133 points)."""
    rounds = jconfig.semantickitti().seg.iteration
    _, jres, res, _ = hs.run_both("clutter", ri3_rounds=rounds)
    diff = (res.removed.numpy() != jres["removed"]).sum(axis=1)
    assert diff.tolist() == [0, 133, 0, 0, 0, 0]


def _table(t):
    return interop.cluster_table_from_numpy(
        {f: np.asarray(getattr(t, f)) for f in TABLE_FIELDS}, "cpu")


@pytest.mark.parametrize("seed", range(20))
def test_pair_step_fuzz_matches_jax(seed):
    """tests/test_oracle_reference.py's scenario for `seed` through both
    _pair_step functions: every output identical."""
    jcfg, cfg = jconfig.tiny_test(), config.tiny_test()
    (prev_table, prev_grid, next_table, next_grid, xyz, flat, valid,
     T_np, counter) = _make_scenario(np.random.default_rng(seed), jcfg)
    want = jtracking._pair_step(
        prev_table, jnp.asarray(prev_grid), next_table,
        jnp.asarray(next_grid), jnp.asarray(xyz), jnp.asarray(flat),
        jnp.asarray(valid), jnp.asarray(T_np),
        jnp.asarray(counter, jnp.int32), cfg=jcfg)
    got = tracking._pair_step(
        _table(prev_table), torch.tensor(prev_grid), _table(next_table),
        torch.tensor(next_grid), torch.tensor(xyz), torch.tensor(flat),
        torch.tensor(valid), torch.tensor(T_np),
        torch.tensor(counter, dtype=torch.int32), cfg)
    for k in (0, 1):          # the final prev table, the mutated next table
        for f in TABLE_FIELDS:
            np.testing.assert_array_equal(
                getattr(got[k], f).numpy(), np.asarray(getattr(want[k], f)),
                err_msg=f"table {k} {f}")
    for k in range(2, 8):     # grid, counter, n_dyn, overflows, clusters
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=f"output {k}")
