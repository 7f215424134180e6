"""The wall-parked cars of tests/test_hard_scenes.py (F = 4) through the
JAX package (RI3 at 24 rounds) and the port at the full semantickitti()
width on the CPU: `removed` identical, the JAX file's PR / RR floors held
by the port. Tolerances: tests/torch_hard_scenes.assert_matches_jax (the
named patchwork float case). tests/test_torch_hard_scenes.py holds the
other two scenes."""

import pytest
import torch_hard_scenes as hs


@pytest.fixture(scope="module")
def wall():
    return hs.run_both("wall")


def test_wall_parked_cars_match_jax(wall):
    win, jres, res, _ = wall
    hs.assert_matches_jax(win, jres, res)


def test_wall_parked_cars_stay_static(wall):
    hs.assert_floors("wall", wall[3])
