"""The port's single-frame entry point and the repo's two tools
(dr_using_scv_od_tpu_torch/entry.py, tools/drive_e2e.py,
tools/cascade_experiment.py) against their JAX counterparts
(__graft_entry__.py, tools/drive_e2e.py, tools/cascade_experiment.py) on
the CPU; drive_e2e's lines are held in tests/test_torch_drive_e2e.py. Each
defaults to the card and raises without one.

Tolerances:
  * entry(): the example arrays identical; fn(*args) against the JAX
    jax.jit(fn)(*args): every integer output identical (label grid, point
    voxels, clusters and routes, the cluster table's integers, cluster
    count, overflow), the cluster bboxes within 1e-6 m (min / max of the
    same points: identical in practice), the features within 1e-5
    relative;
  * cascade_experiment: the NumPy oracle's source identical to the JAX
    tool's; on a 6-frame window at one occupancy (order "asc"), the port's
    segmented frames, `ours_window` and `oracle_window` masks identical to
    the JAX tool's.
"""

import contextlib
import dataclasses
import functools
import inspect
import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as jentry
from tools import cascade_experiment as jcascade
from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu_torch import config, entry, interop
from dr_using_scv_od_tpu_torch.tools import cascade_experiment, drive_e2e


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is visible")


def test_example_frame_equals_jax():
    got = entry._example_frame(config.semantickitti())
    want = jentry._example_frame(jconfig.semantickitti())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _, args = entry.entry("cpu")
    for a, w in zip(args, want):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), w)


def _fixpoint(cfg):
    """cfg with RI3 pinned to 8 rounds: the JAX package bounds RI3 to
    cfg.seg.iteration = 3 rounds on the CPU, where its TPU kernel and the
    port run to the fixpoint, which 8 rounds reach on these scenes (and
    the identical labels below confirm)."""
    return dataclasses.replace(cfg, seg=dataclasses.replace(cfg.seg,
                                                            iteration=8))


def test_entry_matches_jax():
    """entry()'s function and arguments on the CPU against the JAX entry's
    (with RI3 at its fixpoint: at 3 rounds the JAX CPU path stops short
    on this frame, 15 clusters against the fixpoint's 13)."""
    fn, args = entry.entry("cpu")
    got = fn(*args)
    jfn, jargs = jentry.entry()
    want = jax.jit(functools.partial(
        jfn.func, cfg=_fixpoint(jfn.keywords["cfg"])))(*jargs)
    st, jst = got.state, want.state
    for name in ("label_grid", "point_voxel", "point_cluster",
                 "point_route"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    for name in ("valid", "n_points", "n_voxels", "type", "state",
                 "track_id"):
        np.testing.assert_array_equal(getattr(st.clusters, name).numpy(),
                                      np.asarray(getattr(jst.clusters, name)),
                                      err_msg=name)
    for name in ("bbox_min", "bbox_max"):
        np.testing.assert_allclose(getattr(st.clusters, name).numpy(),
                                   np.asarray(getattr(jst.clusters, name)),
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(st.grid.count.numpy(),
                                  np.asarray(jst.grid.count))
    assert int(got.n_clusters) == int(want.n_clusters) > 0
    assert int(got.overflow_points) == int(want.overflow_points)
    for name in got.features._fields:
        np.testing.assert_allclose(getattr(got.features, name).numpy(),
                                   np.asarray(getattr(want.features, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_entry_points_default_to_the_card():
    _no_card()
    with pytest.raises(RuntimeError, match="not available"):
        entry.entry()
    with pytest.raises(RuntimeError, match="not available"):
        drive_e2e.main([])
    with pytest.raises(RuntimeError, match="not available"):
        cascade_experiment.run_experiment(F=2)


def test_cascade_oracle_and_config_are_the_jax_tools():
    """The oracle's source is the JAX tool's; experiment_config() is the
    configuration the JAX tool's run_experiment builds."""
    for name in ("oracle_pair_inloop", "oracle_window"):
        assert inspect.getsource(getattr(cascade_experiment, name)) == \
            inspect.getsource(getattr(jcascade, name))
    j = jconfig.semantickitti()
    want = j.replace(
        grid=dataclasses.replace(j.grid, sector_res=2.4, azimuth_res=4.0),
        shapes=dataclasses.replace(j.shapes, max_points=16384,
                                   max_clusters=256, max_track_points=4096))
    assert cascade_experiment.experiment_config() == \
        interop.config_from_reference(dataclasses.asdict(want))


F_CASCADE = 6
OCC = 0.5


def _cascade_cfg(cfg):
    """run_experiment's configuration (a coarser semantickitti() grid),
    here at 4,096 points and 64 clusters to keep the CPU run short, and
    RI3 at its fixpoint."""
    return _fixpoint(cfg).replace(
        grid=dataclasses.replace(cfg.grid, sector_res=2.4, azimuth_res=4.0),
        shapes=dataclasses.replace(cfg.shapes, max_points=4096,
                                   max_clusters=64, max_track_points=1024))


def _spec(synthetic_mod):
    return synthetic_mod.SceneSpec(
        n_moving_cars=3, n_parked_cars=8, wall_parked_cars=1,
        ground_pts=1500, building_pts=300, tree_pts=100, car_pts=200,
        mover_path="pingpong", stop_frame=F_CASCADE // 2, extent=20.0)


def test_cascade_experiment_matches_jax():
    from dr_using_scv_od_tpu.utils import synthetic as jsynthetic
    from dr_using_scv_od_tpu_torch.utils import synthetic
    jcfg = _cascade_cfg(jconfig.semantickitti())
    cfg = _cascade_cfg(config.semantickitti())
    jwin, jframes, jpairs = jcascade.prepare_frames(jcfg, F_CASCADE,
                                                    _spec(jsynthetic))
    win, frames, pairs = cascade_experiment.prepare_frames(
        cfg, F_CASCADE, _spec(synthetic), device="cpu")
    for f, jf in zip(frames, jframes):
        for k in jf:
            np.testing.assert_array_equal(f[k], jf[k], err_msg=k)
    for p, jp in zip(pairs, jpairs):
        for k in jp:
            np.testing.assert_array_equal(p[k], jp[k], err_msg=k)
    want = jcascade.ours_window(jframes, jcfg, OCC, jwin)
    got = cascade_experiment.ours_window(frames, cfg, OCC, win, device="cpu")
    np.testing.assert_array_equal(got, want)
    want_o = jcascade.oracle_window(jframes, jpairs, jcfg, OCC, "asc")
    got_o = cascade_experiment.oracle_window(frames, pairs, cfg, OCC, "asc")
    np.testing.assert_array_equal(got_o, want_o)
    assert want.any() and want_o.any()
