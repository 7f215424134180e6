"""The port's SLAM-engine parts against the JAX package on the CPU, on the
same numpy inputs: plane.fit_plane, the pose graph (residuals, optimize),
the scan-context descriptor and similarity, ERASOR's clean_map, and
loop_closure.detect.

Tolerances (measured on the CPU in brackets):
  * fit_plane: normals and means within 1e-5 [1.2e-7, 4.8e-7], eigenvalues
    within 1e-5 of the largest [9.5e-6 absolute on eigenvalues near 25],
    counts identical.
  * posegraph.residuals within 1e-5 [4.8e-7]; optimize's poses within 1e-4
    [2.9e-6 on tests/test_posegraph.py's loop graph after 15 Gauss-Newton
    steps of 60 CG steps] and its final error within 1e-5 relative or 1e-8
    absolute (the chain graph converges to an error near 1e-10). The
    per-node sums run in XLA's order (edge order), the matrix products
    and the CG dot products in PyTorch's.
  * descriptor: identical cells. An atan2 that differs in its last bit
    could move a point on a sector border to the next cell; the test
    counts the cells that differ and bounds them at 0 of 192 per scan on
    these scans [0]. similarity: scores within 1e-6 [3.6e-7], shifts and
    yaws identical.
  * clean_map: dynamic and candidate_bins identical, on both scenes of
    tests/test_erasor.py at the default config and at the engine's
    (max_range 45, max_pts_per_bin 256, whose bins overflow) [identical].
    The R-GPF plane fits sum each bin's points in PyTorch's order, so a
    point that lies on its bin's ground threshold can take the other
    verdict: on the engine's map (tests/test_torch_engine.py) 1 of 16,384
    map points does, a named case bounded there.
  * loop_closure.detect on an out-and-back scene: edge indices and
    weights identical, edge_T within 5e-4 [see the test].
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu.models import erasor as jerasor
from dr_using_scv_od_tpu.models import loop_closure as jloop_closure
from dr_using_scv_od_tpu.models import posegraph as jposegraph
from dr_using_scv_od_tpu.models import scan_context as jscan_context
from dr_using_scv_od_tpu.ops import plane as jplane
from dr_using_scv_od_tpu.utils import synthetic
from dr_using_scv_od_tpu_torch import config
from dr_using_scv_od_tpu_torch.models import (erasor, loop_closure,
                                              posegraph, scan_context)
from dr_using_scv_od_tpu_torch.ops import plane

from test_erasor import _scene
from test_posegraph import _noisy_square

POSE_ATOL = 5e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def test_fit_plane_matches_jax():
    rng = np.random.default_rng(0)
    xyz = (rng.normal(size=(64, 32, 3)) * [5.0, 5.0, 0.3]).astype(np.float32)
    mask = rng.random((64, 32)) < 0.7
    mask[3] = False                       # an empty batch row
    want = jplane.fit_plane(jnp.asarray(xyz), jnp.asarray(mask))
    got = plane.fit_plane(_t(xyz), _t(mask))
    for name, g, w in zip(("normal", "mean"), got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=name)
    evals = np.asarray(want[2])
    np.testing.assert_allclose(got[2].numpy(), evals, rtol=0,
                               atol=1e-5 * np.abs(evals).max())
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert (got[0][..., 2] >= 0).all()


def _graphs(loop: bool):
    gt, rels = _noisy_square(np.random.default_rng(0))
    init = np.asarray(jposegraph.odometry_chain(jnp.asarray(rels)))
    F = gt.shape[0]
    if not loop:
        # the chain alone, from poses knocked off it: Gauss-Newton has to
        # pull them back onto the odometry
        noise = np.random.default_rng(1).normal(scale=0.05, size=(F, 3))
        init = init.copy()
        init[1:, :3, 3] += noise[1:].astype(np.float32)
        return init, rels, {}
    T_loop = (np.linalg.inv(gt[F - 1]) @ gt[0]).astype(np.float32)
    return init, rels, dict(loop_i=np.array([F - 1], np.int32),
                            loop_j=np.array([0], np.int32),
                            loop_T=T_loop[None],
                            loop_w=np.array([5.0], np.float32))


@pytest.mark.parametrize("loop", [False, True], ids=["chain", "loop"])
def test_posegraph_matches_jax(loop):
    init, rels, kw = _graphs(loop)
    jg = jposegraph.make_odometry_graph(
        jnp.asarray(init), jnp.asarray(rels),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    g = posegraph.make_odometry_graph(_t(init), _t(rels),
                                      **{k: _t(v) for k, v in kw.items()})
    for name in ("edge_i", "edge_j", "edge_w"):
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    np.testing.assert_allclose(posegraph.residuals(g).numpy(),
                               np.asarray(jposegraph.residuals(jg)),
                               rtol=0, atol=1e-5)
    want = jposegraph.optimize(jg, gn_iters=15, cg_iters=60)
    got = posegraph.optimize(g, gn_iters=15, cg_iters=60)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                               rtol=0, atol=1e-4)
    # the chain converges to an error near 1e-10, where only the absolute
    # bound means anything
    np.testing.assert_allclose(float(got.final_error),
                               float(want.final_error), rtol=1e-5,
                               atol=1e-8)
    assert int(got.n_iters) == 15 and got.n_iters.dtype == torch.int32
    # node 0 is the gauge: it never moves
    np.testing.assert_array_equal(got.poses[0].numpy(), init[0])


def test_descriptor_and_similarity_match_jax():
    """tests/test_engine.py:205-223's yaw case (a scan and its copy
    rotated by two sectors) and random scans."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-25, 25, size=(4000, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1.7, 6.0, size=4000)
    jcfg, cfg = jscan_context.DescriptorConfig(), \
        scan_context.DescriptorConfig()
    yaw = 2 * (2 * np.pi / cfg.sectors)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    scans = [pts, pts @ R.T] + [
        rng.uniform(-30, 30, size=(4000, 3)).astype(np.float32)
        for _ in range(4)]
    valid = rng.random(4000) < 0.95
    jd = np.stack([np.asarray(jscan_context.descriptor(
        jnp.asarray(p), jnp.asarray(valid), jcfg)) for p in scans])
    td = torch.stack([scan_context.descriptor(_t(p), _t(valid), cfg)
                      for p in scans])
    assert td.shape == (6, cfg.rings, cfg.sectors)
    moved_cells = (td.numpy() != jd).reshape(6, -1).sum(1)
    assert moved_cells.max() == 0, moved_cells

    bank_valid = np.ones(6, bool)
    bank_valid[4] = False
    for q in range(6):
        want = jscan_context.similarity(jnp.asarray(jd[q]), jnp.asarray(jd),
                                        jnp.asarray(bank_valid))
        got = scan_context.similarity(_t(jd[q]), _t(jd), _t(bank_valid))
        ws, gs = np.asarray(want.scores), got.scores.numpy()
        np.testing.assert_array_equal(np.isfinite(gs), bank_valid)
        np.testing.assert_allclose(gs[bank_valid], ws[bank_valid], rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(got.shifts.numpy(),
                                      np.asarray(want.shifts))
        np.testing.assert_array_equal(got.yaw.numpy(), np.asarray(want.yaw))
    # the batched form equals the per-query one
    batched = scan_context.similarity(td, td, torch.ones(6, 6, dtype=bool))
    one = scan_context.similarity(td[1], td, torch.ones(6, dtype=bool))
    np.testing.assert_array_equal(batched.shifts[1].numpy(),
                                  one.shifts.numpy())
    # the yaw case retrieves itself two sectors round (test_engine.py)
    assert float(one.scores[0]) > 0.95
    assert abs(float(one.yaw[0]) - (2 * np.pi - yaw)) < 1e-5


@pytest.mark.parametrize("car_left", [True, False],
                         ids=["departed-car", "static"])
@pytest.mark.parametrize("engine_cfg", [False, True],
                         ids=["default", "engine-cfg"])
def test_clean_map_matches_jax(car_left, engine_cfg):
    rng = np.random.default_rng(0)
    map_pts, kind = _scene(rng, with_car=True)
    scan_pts, _ = _scene(rng, with_car=not car_left)
    kw = dict(max_range=45.0, max_pts_per_bin=256) if engine_cfg else {}
    map_valid = np.ones(len(map_pts), bool)
    map_valid[::97] = False
    want = jerasor.clean_map(jnp.asarray(map_pts), jnp.asarray(map_valid),
                             jnp.asarray(scan_pts),
                             jnp.ones(len(scan_pts), bool), jnp.zeros(3),
                             jerasor.ErasorConfig(**kw))
    got = erasor.clean_map(_t(map_pts), _t(map_valid), _t(scan_pts),
                           torch.ones(len(scan_pts), dtype=torch.bool),
                           torch.zeros(3), erasor.ErasorConfig(**kw))
    np.testing.assert_array_equal(got.dynamic.numpy(),
                                  np.asarray(want.dynamic))
    np.testing.assert_array_equal(got.candidate_bins.numpy(),
                                  np.asarray(want.candidate_bins))
    assert int(got.bin_overflow) == int(want.bin_overflow)
    assert got.bin_overflow.dtype == torch.int32
    dyn = got.dynamic.numpy()
    if engine_cfg:   # bins past 256 points overflow: no floors there
        return
    if car_left:     # tests/test_erasor.py's floors
        assert dyn[kind == 2].mean() > 0.7
        assert dyn[kind == 0].mean() < 0.02
        assert dyn[kind == 1].mean() < 0.05
    else:
        assert dyn.mean() < 0.02


def test_loop_detect_matches_jax():
    """An out-and-back drive through a static scene (frames 0-5, then the
    same scans in reverse), with 1 m of drift in the pose estimates: the
    returning scans must verify against the outgoing ones."""
    spec = synthetic.SceneSpec(n_moving_cars=0, ground_pts=9000,
                               building_pts=1200, tree_pts=300, car_pts=200,
                               ego_speed=1.0)
    win = synthetic.render_window(synthetic.make_scene(spec), 6, 8000)
    xyz = np.concatenate([win["xyz"], win["xyz"][::-1]])
    valid = np.concatenate([win["valid"], win["valid"][::-1]])
    est = np.concatenate([win["poses"], win["poses"][::-1]]).copy()
    est[:, 0, 3] += np.linspace(0.0, 1.0, 12, dtype=np.float32)
    jlc = jloop_closure.LoopConfig(min_gap=6, radius=4.0)
    lc = loop_closure.LoopConfig(min_gap=6, radius=4.0)
    want = jloop_closure.detect(jnp.asarray(xyz), jnp.asarray(valid),
                                jnp.asarray(est), jconfig.semantickitti(),
                                jlc)
    got = loop_closure.detect(_t(xyz), _t(valid), _t(est),
                              config.semantickitti(), lc)
    for name in ("edge_i", "edge_j", "edge_w", "n_accepted"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.edge_T.numpy(), np.asarray(want.edge_T),
                               rtol=0, atol=POSE_ATOL)
    assert int(got.n_accepted) >= 1
    ei, ej = got.edge_i.numpy(), got.edge_j.numpy()
    used = ei >= 0
    assert (np.abs(ei[used] - ej[used]) > 6).all()
