"""The port's streaming SLAM engine (models/engine.py) against the JAX
package on the CPU: the state and config round trip through `interop`,
each helper of the window step fed the same JAX state, one streaming run
of both SlamEngines, and checkpoints resumed across the packages in both
directions.

Config: tests/test_engine.py's small_cfg narrowed to N = 8192 points and
C = 128 cluster rows, on its 24-frame loop scene (4.7 m and 15 degrees per
frame, two moving cars); EngineConfig window 4 (3 windows over 10 frames),
K = 16 keyframes of P = 1024 points, distance and rotation gating on,
ERASOR at finalize (its per-window pass is `_erasor_pass`, held on its
own below; one more jitted variant of the JAX window step would cost
~20 s of compile).

Tolerances (measured on the CPU in brackets):
  * integer outputs identical: is_kf, kf_slot, kf_frame, n, frames,
    n_loops, loop_pair, submap_fill, submap_idx, submap_frame, the
    tracking carry's rows (valid, type, state, track_id) and counter, and
    every overflow and fallback counter [identical]. The per-window
    dynamic verdicts `removed` may differ on at most 0.1 % of the valid
    points [identical]. The carry's n_points, n_voxels and label grid are
    identical after window 1; from window 2 on a point on a voxel border
    can change voxel, and at most 2 entries (or 0.1 %) may differ [one
    cluster's n_points, by 1], so the states of window 2 on are held to
    the bounds of window 3; bboxes within 10x the pose bound.
  * poses, where the registrations are well conditioned: within 5e-4.
    _window_odometry fed the same state as the JAX function run eagerly:
    windows 1 and 2 [3.8e-6, 2.2e-4]; the streaming run's windows 1 and 2
    [1.5e-4, 4.3e-4]; the loop edges, the pose graph and the keyframe
    edges.
  * poses of window 3 and after: within 1e-2, the JAX package's own
    spread there. Window 3's local map holds a voxel whose covariance is
    nearly singular, so its GICP weight (~1e3) moves with the last bits of
    its sums, and the registrations stop at their iteration cap: the JAX
    function jitted (as SlamEngine runs it) and run eagerly differ by
    6.7e-3 on that window, the port differs from them by 4.2e-3 and 2.7e-3
    [2.1e-3 in the streaming run]. The cross-package resumes run window 3,
    so they are held to the same bound.
  * ERASOR: erasor_removed within 2 map points and submap_valid within
    0.1 % of the map slots. Its R-GPF plane fits sum in PyTorch's order,
    so a point on its bin's ground threshold may take the other verdict
    (1 of 16,384 in _erasor_pass on the state after window 2, also when
    both packages get bit-identical inputs), and its bins follow the
    poses [identical in the streaming run].
  * odometry correspondence counts within 1 % [2 of ~5,000].
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu.models import engine as jengine
from dr_using_scv_od_tpu.utils import synthetic
from dr_using_scv_od_tpu_torch import config, interop
from dr_using_scv_od_tpu_torch.models import engine

N = 8192
F = 10
CKPT_FRAMES = 7      # after window 2
POSE_ATOL = 5e-4     # well-conditioned registrations
SPREAD_ATOL = 1e-2   # window 3 on: the JAX package's own spread


def _cfg(mod):
    cfg = mod.semantickitti()
    return cfg.replace(
        grid=dataclasses.replace(cfg.grid, sector_res=2.4, azimuth_res=4.0),
        shapes=dataclasses.replace(cfg.shapes, max_points=N,
                                   max_clusters=128, max_track_points=2048),
        gicp=dataclasses.replace(cfg.gicp, xy_extent=48.0))


def _ec(mod):
    return mod.EngineConfig(
        window=4, max_keyframes=16, submap_points=1024, local_map_kf=2,
        kf_dist=6.0, kf_rot=0.5, loop_min_gap=4,
        erasor=dataclasses.replace(mod.erasor_mod.ErasorConfig(),
                                   max_range=45.0, max_pts_per_bin=128),
        erasor_every=0)


CFG, JCFG = _cfg(config), _cfg(jconfig)
EC, JEC = _ec(engine), _ec(jengine)


@pytest.fixture(scope="module")
def win():
    spec = synthetic.SceneSpec(
        trajectory="loop", loop_frames=24, loop_radius=18.0,
        ground_pts=6000, building_pts=800, tree_pts=200, car_pts=250,
        n_moving_cars=2)
    return synthetic.render_window(synthetic.make_scene(spec), F, N)


def _leaves(state):
    if isinstance(state, engine.EngineState):
        return interop.engine_state_to_numpy(state)
    return [np.asarray(a) for a in jax.tree.leaves(state)]


def _drive(eng, win, frames, ckpt_path=None):
    """Feed `frames`; returns {window: (output, state leaves)} and, when
    `ckpt_path` is given, checkpoints after CKPT_FRAMES frames."""
    out = {}
    for f in frames:
        o = eng.feed(win["xyz"][f], win["intensity"][f], win["valid"][f])
        if o is not None:
            out[eng.windows] = (o, _leaves(eng.state))
        if ckpt_path is not None and eng.n_frames == CKPT_FRAMES \
                and f == CKPT_FRAMES - 1:
            eng.checkpoint(ckpt_path)
    eng.finalize(final_erasor=True)
    return out, _leaves(eng.state)


@pytest.fixture(scope="module")
def jax_run(win, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax") / "ckpt")
    eng = jengine.SlamEngine(JCFG, JEC)
    windows, final = _drive(eng, win, range(F), path)
    return windows, final, path


@pytest.fixture(scope="module")
def torch_run(win, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch") / "ckpt")
    eng = engine.SlamEngine(CFG, EC, device="cpu")
    windows, final = _drive(eng, win, range(F), path)
    return windows, final, path


def _jstate(leaves):
    """A JAX EngineState from numpy leaves."""
    tmpl = jengine.init_state(JEC, JCFG)
    return jax.tree.unflatten(jax.tree.structure(tmpl),
                              [jnp.asarray(a) for a in leaves])


def _tstate(leaves):
    return interop.engine_state_from_numpy(leaves, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


_NAMES = [f.name for f in dataclasses.fields(engine.EngineState)
          if f.name != "track_table"]
_NAMES[_NAMES.index("track_grid"):_NAMES.index("track_grid")] = [
    f"track_table.{f.name}"
    for f in dataclasses.fields(engine.ClusterTable)]
_INT_EXACT = ("n", "frames", "kf_frame", "submap_idx", "submap_frame",
              "submap_fill", "loop_i", "loop_j", "n_loops",
              "track_table.valid", "track_table.type",
              "track_table.state", "track_table.track_id",
              "track_counter", "row_overflow", "point_overflow",
              "submap_overflow", "kf_overflow", "odo_fallbacks")
# the tracking carry's per-cluster extents: identical in the first window,
# and where the poses differ by the JAX package's spread a point on a
# voxel border can change voxel (one point of one cluster after window 3)
_CARRY = ("track_table.n_points", "track_table.n_voxels", "track_grid")
_POSES = ("poses", "rel_T", "last_pose", "last_rel")


def _assert_states_match(got, want, pose_atol):
    got = dict(zip(_NAMES, got))
    want = dict(zip(_NAMES, want))
    for name in _NAMES:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
    for name in _INT_EXACT:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in _CARRY:
        n_diff = int((got[name] != want[name]).sum())
        if pose_atol <= POSE_ATOL:
            assert n_diff == 0, name
        else:
            assert n_diff <= max(2, got[name].size // 1000), (name, n_diff)
    np.testing.assert_allclose(got["track_table.bbox_min"],
                               want["track_table.bbox_min"], rtol=0,
                               atol=10 * pose_atol)
    np.testing.assert_allclose(got["track_table.bbox_max"],
                               want["track_table.bbox_max"], rtol=0,
                               atol=10 * pose_atol)
    for name in _POSES:
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=pose_atol, err_msg=name)
    assert abs(int(got["erasor_removed"]) - int(want["erasor_removed"])) <= 2
    n_diff = int((got["submap_valid"] != want["submap_valid"]).sum())
    assert n_diff <= got["submap_valid"].size // 1000, n_diff
    np.testing.assert_allclose(got["desc"], want["desc"], rtol=0, atol=1e-6)
    for name in ("loop_T", "loop_w"):
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=POSE_ATOL, err_msg=name)


def _assert_outputs_match(got, want, valid, pose_atol):
    for name in ("is_kf", "kf_slot", "n_dynamic", "loop_accepted",
                 "loop_pair"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    removed_diff = int((np.asarray(got.removed)
                        != np.asarray(want.removed)).sum())
    assert removed_diff <= int(valid.sum()) // 1000, removed_diff
    np.testing.assert_allclose(np.asarray(got.poses), np.asarray(want.poses),
                               rtol=0, atol=pose_atol)
    nc, jnc = np.asarray(got.odo_n_corr), np.asarray(want.odo_n_corr)
    assert (np.abs(nc - jnc) <= 0.01 * jnc).all(), (nc, jnc)


# ---------------------------------------------------------------------------
# state and config


def test_config_and_fingerprint_match_jax():
    assert repr((EC, CFG)) == repr((JEC, JCFG))
    assert interop.engine_config_from_reference(
        dataclasses.asdict(JEC)) == EC
    assert engine.SlamEngine(CFG, EC, device="cpu")._config_fingerprint() \
        == jengine.SlamEngine(JCFG, JEC)._config_fingerprint()


def test_state_round_trip_through_interop(jax_run):
    want = jax_run[1]
    tmpl_j = _leaves(jengine.init_state(JEC, JCFG))
    tmpl_t = _leaves(engine.init_state(EC, CFG, "cpu"))
    assert len(tmpl_t) == len(tmpl_j) == len(_NAMES) == 34
    for name, a, b in zip(_NAMES, tmpl_t, tmpl_j):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    back = interop.engine_state_to_numpy(_tstate(want))
    for name, a, b in zip(_NAMES, back, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------------------
# the helpers, fed the state the JAX engine held after window 2


@pytest.fixture(scope="module")
def state2(jax_run):
    return jax_run[0][2][1]


def _window3(win):
    sl = slice(CKPT_FRAMES - 1, F)
    return win["xyz"][sl], win["intensity"][sl], win["valid"][sl]


@pytest.mark.parametrize("window", [1, 2, 3])
def test_window_odometry_matches_jax(win, jax_run, window):
    """Each window's odometry from the state the JAX engine held before
    it: the cold start (register_global) and two steady windows."""
    first = window == 1
    state = (_leaves(jengine.init_state(JEC, JCFG)) if first
             else jax_run[0][window - 1][1])
    lo = 0 if first else 3 * window - 3
    xyz, valid = win["xyz"][lo:lo + 4], win["valid"][lo:lo + 4]
    want = jengine._window_odometry(_jstate(state), jnp.asarray(xyz),
                                    jnp.asarray(valid), first, JEC, JCFG)
    got = engine._window_odometry(_tstate(state), _t(xyz), _t(valid),
                                  first, EC, CFG)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=POSE_ATOL if window < 3 else SPREAD_ATOL)
    nc, jnc = got[1].numpy(), np.asarray(want[1])
    assert (np.abs(nc - jnc) <= 0.01 * jnc).all()
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[4]) == int(want[4]) == 0


def test_keyframe_gate_matches_jax(jax_run, state2):
    """Gated selection (kf_dist and kf_rot on) over window 3's poses;
    gating leaves some scans without a keyframe of their own."""
    poses_win = np.asarray(jax_run[0][3][0].poses)
    for first in (False, True):
        want = jengine._keyframe_gate(_jstate(state2),
                                      jnp.asarray(poses_win), first, JEC)
        got = engine._keyframe_gate(_tstate(state2), _t(poses_win), first,
                                    EC)
        for i in (0, 1, 3):
            np.testing.assert_array_equal(got[i].numpy(),
                                          np.asarray(want[i]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=0, atol=1e-5)
        assert got[1].dtype == torch.int32 and got[3].dtype == torch.int32
    all_kf = np.concatenate([np.asarray(o.is_kf)[1:]
                             for o, _ in jax_run[0].values()])
    assert 0 < all_kf.sum() < all_kf.size


def test_insert_submaps_matches_jax(win, jax_run, state2):
    out3 = jax_run[0][3][0]
    xyz, _, valid = _window3(win)
    frame_ids = np.arange(CKPT_FRAMES - 1, F, dtype=np.int32)
    args = (xyz[:-1], valid[:-1], np.asarray(out3.removed),
            state2[_NAMES.index("poses")], np.asarray(out3.poses)[:-1],
            np.asarray(out3.kf_slot)[:-1], np.asarray(out3.is_kf)[:-1],
            frame_ids[:-1])
    want = jengine._insert_submaps(_jstate(state2),
                                   *[jnp.asarray(a) for a in args], JEC)
    got = engine._insert_submaps(_tstate(state2), *[_t(a) for a in args], EC)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[4].sum()) > int(state2[_NAMES.index("submap_fill")].sum())


def test_world_map_and_erasor_pass_match_jax(win, state2):
    pose = state2[_NAMES.index("last_pose")]
    xyz = win["xyz"][CKPT_FRAMES - 1]
    valid = win["valid"][CKPT_FRAMES - 1]
    jpts, jval = jengine.world_map(_jstate(state2))
    pts, val = engine.world_map(_tstate(state2))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    want = jengine._erasor_pass(_jstate(state2), jnp.asarray(xyz),
                                jnp.asarray(valid), jnp.asarray(pose), JEC)
    got = engine._erasor_pass(_tstate(state2), _t(xyz), _t(valid), _t(pose),
                              EC)
    # the named R-GPF case: a map point on its bin's ground threshold may
    # take the other verdict [1 of 16,384, also on identical inputs]
    n_diff = int((got[0].numpy() != np.asarray(want[0])).sum())
    assert n_diff <= got[0].numel() // 1000, n_diff
    assert abs(int(got[1]) - int(want[1])) <= 2
    assert int(got[1]) > 0 and got[1].dtype == torch.int32


@pytest.fixture(scope="module")
def revisit(win, state2):
    """A window that revisits the start: the boundary scan, then frames
    0-2 again as new keyframes. Their descriptors match the bank's
    keyframes of the first window."""
    from dr_using_scv_od_tpu.models import scan_context as jsc
    n = int(state2[0])
    frames = [CKPT_FRAMES - 1, 0, 1, 2]
    xyz, valid = win["xyz"][frames], win["valid"][frames]
    descs = np.stack([np.asarray(jsc.descriptor(
        jnp.asarray(xyz[i]), jnp.asarray(valid[i]), JEC.desc))
        for i in range(4)])
    slots = np.array([n - 1, n, n + 1, n + 2], np.int32)
    is_kf = np.array([False, True, True, True])
    args = (xyz, valid, descs, slots, is_kf)
    want = jengine._window_loops(_jstate(state2),
                                 *[jnp.asarray(a) for a in args], False,
                                 JEC, JCFG)
    got = engine._window_loops(_tstate(state2), *[_t(a) for a in args],
                               False, EC, CFG)
    return want, got


def test_window_loops_matches_jax(revisit):
    (jtab, jacc, jpairs, jdiag), (tab, acc, pairs, diag) = revisit
    assert int(acc.sum()) >= 1, "the revisit proposed no accepted edge"
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(pairs.numpy(), np.asarray(jpairs))
    for name, g, w in zip(("loop_i", "loop_j", "loop_T", "loop_w",
                           "n_loops"), tab, jtab):
        assert g.numpy().dtype == np.asarray(w).dtype, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=POSE_ATOL, err_msg=name)
    np.testing.assert_array_equal(tab[0].numpy(), np.asarray(jtab[0]))
    np.testing.assert_array_equal(tab[1].numpy(), np.asarray(jtab[1]))
    np.testing.assert_allclose(diag[0].numpy(), np.asarray(jdiag[0]),
                               rtol=0, atol=1e-6)
    verified = np.isfinite(np.asarray(jdiag[1]))
    np.testing.assert_array_equal(np.isfinite(diag[1].numpy()), verified)
    nc, jnc = diag[2].numpy(), np.asarray(jdiag[2])
    assert (np.abs(nc - jnc) <= 0.01 * jnc).all()
    # the edge spans the revisit: an old keyframe to a new one
    p = pairs.numpy()[acc.numpy()]
    assert (p[:, 1] - p[:, 0] >= EC.loop_min_gap).all()


def test_run_pgo_matches_jax(revisit, state2):
    """The pose graph over the keyframe chain plus the revisit's edges."""
    jtab = revisit[0][0]
    leaves = list(state2)
    for name, a in zip(("loop_i", "loop_j", "loop_T", "loop_w", "n_loops"),
                       jtab):
        leaves[_NAMES.index(name)] = np.asarray(a)
    n = int(leaves[0])
    want = jengine._run_pgo(_jstate(leaves), jnp.asarray(n, jnp.int32), JEC)
    got = engine._run_pgo(_tstate(leaves), torch.tensor(n, dtype=torch.int32),
                          EC)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=POSE_ATOL)
    # the residual left is near 1e-11, where only an absolute bound means
    # anything
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-4,
                               atol=1e-8)
    moved = np.abs(got[0].numpy() - leaves[_NAMES.index("poses")]).max()
    assert moved > 1e-3, "the loop edges did not move the graph"


# ---------------------------------------------------------------------------
# streaming


def test_streaming_run_matches_jax(win, jax_run, torch_run):
    jw, jfinal, _ = jax_run
    tw, tfinal, _ = torch_run
    assert sorted(tw) == sorted(jw) == [1, 2, 3]
    for k in (1, 2, 3):
        _assert_outputs_match(tw[k][0], jw[k][0], win["valid"],
                              POSE_ATOL if k < 3 else SPREAD_ATOL)
        _assert_states_match(tw[k][1], jw[k][1],
                             POSE_ATOL if k == 1 else SPREAD_ATOL)
    _assert_states_match(tfinal, jfinal, SPREAD_ATOL)
    final = dict(zip(_NAMES, tfinal))
    assert int(final["frames"]) == F and int(final["erasor_removed"]) > 0


def test_jax_checkpoint_resumes_in_the_port(win, jax_run):
    """A JAX checkpoint after window 2 continues in the port as the JAX
    run continued."""
    jw, jfinal, path = jax_run
    eng = engine.SlamEngine.resume(path, CFG, EC, device="cpu")
    assert eng.n_frames == CKPT_FRAMES and eng.windows == 2
    tw, tfinal = _drive(eng, win, range(CKPT_FRAMES, F))
    _assert_outputs_match(tw[3][0], jw[3][0], win["valid"], SPREAD_ATOL)
    _assert_states_match(tfinal, jfinal, SPREAD_ATOL)


def test_port_checkpoint_resumes_in_jax(win, torch_run):
    """The reverse: the port's checkpoint continues in the JAX engine as
    the port's run continued."""
    tw, tfinal, path = torch_run
    eng = jengine.SlamEngine.resume(path, JCFG, JEC)
    assert eng.n_frames == CKPT_FRAMES and eng.windows == 2
    jw, jfinal = _drive(eng, win, range(CKPT_FRAMES, F))
    _assert_outputs_match(jw[3][0], tw[3][0], win["valid"], SPREAD_ATOL)
    _assert_states_match(jfinal, tfinal, SPREAD_ATOL)


def test_port_resume_is_exact(win, torch_run):
    """The port's own checkpoint resumes to the very state its
    uninterrupted run reached (tests/test_engine.py:166-202)."""
    tw, tfinal, path = torch_run
    eng = engine.SlamEngine.resume(path, CFG, EC, device="cpu")
    rw, rfinal = _drive(eng, win, range(CKPT_FRAMES, F))
    for name, a, b in zip(_NAMES, rfinal, tfinal):
        np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b in zip(rw[3][0], tw[3][0]):
        np.testing.assert_array_equal(a, b)


def test_resume_rejects_another_config(torch_run):
    with pytest.raises(ValueError, match="config mismatch"):
        engine.SlamEngine.resume(torch_run[2], CFG,
                                 dataclasses.replace(EC, submap_points=512),
                                 device="cpu")
