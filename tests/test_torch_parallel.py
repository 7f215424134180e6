"""The port's parallel layer against the JAX package's, on the CPU: the
port's ranks are spawned processes in a gloo group (tests/torch_mp_worker.py,
a file store under tmp_path, each wait bounded), the JAX references run in
this process on the virtual CPU devices of tests/conftest.py, on meshes of
the same size. One world of 1, 2 and 4 ranks each; every rank gets the
whole window and must return the same results as every other rank.

Scene: the `tiny` scene of the command line on the tiny_test profile, the
window under which tests/test_torch_cli.py holds segdf identical.

Tolerances:
  * sharded_run_window (removed, states, n_dynamic), the tp_voxel_stats
    counts and every integer output of pipelined_process_window: none;
  * tp_voxel_stats mean and variance: 2e-6 relative (1e-6 absolute near
    zero). Each rank's partial sums are order-exact; the all-reduce adds
    the two or four partial sums in its own order and the JAX psum in its
    (5.6e-7 relative measured, on 3 of 4,608 voxels at four ranks);
  * pipelined_process_window's feature `area`: 1e-6 relative, as in
    tests/test_pipeline_parallel.py (it is identical here).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu.models import pipeline as jpipeline
from dr_using_scv_od_tpu.parallel import mesh as jmesh
from dr_using_scv_od_tpu.parallel import pipeline_parallel as jpp
from dr_using_scv_od_tpu.parallel import sharded_pipeline as jsharded
from dr_using_scv_od_tpu.parallel import tensor_parallel as jtp
from dr_using_scv_od_tpu_torch import config
from dr_using_scv_od_tpu_torch.parallel import mesh, pipeline_parallel
from dr_using_scv_od_tpu_torch.utils import synthetic

import torch_mp_worker

F = 8
PP_FRAMES = 5                 # deliberately != any stage count
WORLD_TIMEOUT = 240.0
TINY_SPEC = dict(ground_pts=1500, building_pts=300, tree_pts=100,
                 car_pts=120, n_buildings=2, n_trees=3, n_parked_cars=2,
                 n_moving_cars=2, extent=14.0, moving_speed=4.0,
                 ego_speed=1.0, seed=0)
# world size -> (jobs, pipeline stages)
WORLDS = {1: (["sharded", "pp"], 1),
          2: (["sharded", "tp", "pp", "scaling", "dryrun"], 2),
          4: (["sharded", "tp", "pp", "scaling"], 3)}


@pytest.fixture(scope="module")
def window():
    return synthetic.render_window(
        synthetic.make_scene(synthetic.SceneSpec(**TINY_SPEC)), F,
        config.tiny_test().shapes.max_points)


@pytest.fixture(scope="module")
def ranks(window, tmp_path_factory):
    """{world: [rank results]}: the three spawned worlds."""
    out = {}
    for world, (jobs, stages) in WORLDS.items():
        out[world] = torch_mp_worker.spawn_world(
            world, tmp_path_factory.mktemp(f"world{world}"), jobs,
            dict(window, pp_frames=PP_FRAMES, pp_stages=stages),
            WORLD_TIMEOUT)
    return out


@pytest.fixture(scope="module")
def jax_runs(window):
    cfg = jconfig.tiny_test()
    args = [jnp.asarray(window[k]) for k in ("xyz", "intensity", "valid",
                                             "poses")]
    sharded = {n: [np.asarray(a) for a in jsharded.sharded_run_window(
        *args, cfg, jmesh.make_mesh(n))] for n in (2, 4)}
    tp = {n: jtp.tp_voxel_stats(args[0][0], args[1][0], args[2][0],
                                cfg.grid,
                                jmesh.make_mesh(n, axis_names=("tp",)))
          for n in (2, 4)}
    single = jpipeline.run_window(*args, cfg)
    pp_args = [a[:PP_FRAMES] for a in args[:3]]
    pp = {s: jpp.pipelined_process_window(
        *pp_args, cfg, jmesh.make_mesh(s, axis_names=("pp",)))
        for s in (2, 3)}
    frames = jpipeline.process_window(*pp_args, args[3][:PP_FRAMES], cfg)
    return dict(sharded=sharded, tp=tp, single=single, pp=pp, frames=frames)


def _replicated(results, keys):
    for r, res in enumerate(results[1:], 1):
        for k in keys:
            np.testing.assert_array_equal(res[k], results[0][k],
                                          err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_run_window_matches_jax(ranks, jax_runs, world):
    got = ranks[world]
    _replicated(got, ("removed", "states", "n_dynamic"))
    removed, states, n_dyn = jax_runs["sharded"][world]
    np.testing.assert_array_equal(got[0]["removed"], removed)
    np.testing.assert_array_equal(got[0]["states"], states)
    np.testing.assert_array_equal(got[0]["n_dynamic"], n_dyn)
    assert got[0]["removed"].dtype == bool
    assert got[0]["n_dynamic"][-1] == 0 and got[0]["n_dynamic"].sum() > 0


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_interior_frames_match_run_window(ranks, jax_runs, world):
    """mp_worker.py:76-87: every pair inside a block (not across a block
    boundary) gets the single-device run's verdict count; at one rank every
    pair is inside, and the removed mask of frames 0..F-2 is identical."""
    got = ranks[world][0]
    want = np.asarray(jax_runs["single"].n_dynamic)
    block = F // world
    interior = [f for f in range(F - 1) if (f + 1) % block != 0]
    assert interior
    np.testing.assert_array_equal(got["n_dynamic"][interior], want[interior])
    if world == 1:
        np.testing.assert_array_equal(
            got["removed"][:F - 1],
            np.asarray(jax_runs["single"].removed)[:F - 1])


@pytest.mark.parametrize("world", [2, 4])
def test_tp_voxel_stats_matches_jax(ranks, jax_runs, world):
    got = ranks[world]
    _replicated(got, ("tp_count", "tp_mean", "tp_var"))
    want = jax_runs["tp"][world]
    np.testing.assert_array_equal(got[0]["tp_count"], np.asarray(want.count))
    assert got[0]["tp_count"].sum() > 0
    for k, v in (("tp_mean", want.intensity_mean),
                 ("tp_var", want.intensity_var)):
        np.testing.assert_allclose(got[0][k], np.asarray(v), rtol=2e-6,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_pipelined_process_window_matches(ranks, jax_runs, world):
    """Identical to the JAX process_window (and, at 2 and 3 stages, to the
    JAX pipelined_process_window); every rank of the world holds it, the
    rank outside the three stages of the world of 4 included."""
    got = ranks[world]
    _replicated(got, [k for k in got[0] if k.startswith("pp_")])
    stages = WORLDS[world][1]
    frames = jax_runs["frames"]
    refs = [(np.asarray(frames.state.point_voxel),
             np.asarray(frames.state.point_cluster),
             np.asarray(frames.state.label_grid),
             np.asarray(frames.n_clusters), frames.state.clusters,
             np.asarray(frames.features.area))]
    if stages in jax_runs["pp"]:
        p = jax_runs["pp"][stages]
        refs.append((np.asarray(p.point_voxel), np.asarray(p.point_cluster),
                     np.asarray(p.label_grid), np.asarray(p.n_clusters),
                     p.table, np.asarray(p.feats.area)))
    for pv, pc, lg, nc, table, area in refs:
        np.testing.assert_array_equal(got[0]["pp_point_voxel"], pv)
        np.testing.assert_array_equal(got[0]["pp_point_cluster"], pc)
        np.testing.assert_array_equal(got[0]["pp_label_grid"], lg)
        np.testing.assert_array_equal(got[0]["pp_n_clusters"], nc)
        for name in ("valid", "type", "n_points", "bbox_min"):
            np.testing.assert_array_equal(got[0][f"pp_{name}"],
                                          np.asarray(getattr(table, name)))
        np.testing.assert_allclose(got[0]["pp_area"], area, rtol=1e-6)
    assert got[0]["pp_n_clusters"].min() > 0


@pytest.mark.parametrize("world", [2, 4])
def test_measure_scaling_table(ranks, world):
    """test_sweep_scaling.py:95's shape: one row per rank count that
    divides the window, the same table on every rank."""
    got = ranks[world]
    _replicated(got, ("scaling",))
    rows = got[0]["scaling"]
    assert rows.shape == (2, 3)
    np.testing.assert_array_equal(rows[:, 0], [1, world])
    assert (rows[:, 1] > 0).all() and rows[0, 2] == 1.0


def test_dryrun_multichip(ranks):
    assert all(r["dryrun_ok"] for r in ranks[2])


def test_make_stages_partitions():
    cfg = config.tiny_test()
    assert [len(pipeline_parallel.make_stages(cfg, n))
            for n in (1, 2, 3, 4)] == [1, 2, 3, 4]
    with pytest.raises(ValueError):
        pipeline_parallel.make_stages(cfg, 0)


def test_frame_block():
    assert [mesh.frame_block(8, r, 4) for r in range(4)] == \
        [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError):
        mesh.frame_block(10, 0, 4)
