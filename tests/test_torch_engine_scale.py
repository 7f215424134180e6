"""The port's SLAM engine over a sequence several times its keyframe
budget, against the JAX package on the CPU: the scenarios of
tests/test_engine_scale.py, which the port runs through
`tools/engine_scale.py` (the same scenarios on any device; `chip_smoke.py`
phase 15 runs them on the card).

Fast tier:
  * the budget case: without gating, 12 scans through K = 8 keyframes.
    Both packages raise the same keyframe-budget error and keep the same
    8 keyframes;
  * the false-positive case: keyframe slot 1 poisoned with the query's
    own descriptor and a submap of noise 200-260 m away (the same numpy
    points for both packages). Both retrieve the same candidates, reject
    the poisoned one in GICP verification, accept the same genuine edge
    and end with the same loop edges; scores within 1e-5.

Slow tier (`-m slow`, ~4 min alone on an 8-core CPU, most of it JAX):
the 96-scan long run through both packages. Each window stepped by the
port from the JAX run's state makes the JAX run's keyframe and loop
decisions; the two streaming runs make the same decisions through window
10 and then part (a loop verification at its correspondence floor), so
their later keyframes and loops differ. Every floor of
tests/test_engine_scale.py on the port's run.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_engine_scale.py -q
    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_engine_scale.py -q -m slow
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu.models import engine as jengine
from dr_using_scv_od_tpu.models import scan_context as jscan_context
from dr_using_scv_od_tpu_torch.models import engine
from dr_using_scv_od_tpu_torch.tools import engine_scale
from dr_using_scv_od_tpu_torch.utils import synthetic

SCORE_ATOL = 1e-5
STREAM_WINDOWS = 10
STREAM_POSE_ATOL = 2.5e-2


def _jax_tiny_cfg():
    cfg = jconfig.semantickitti()
    tiny = engine_scale.tiny_cfg()
    return cfg.replace(
        grid=dataclasses.replace(cfg.grid, **{
            k: getattr(tiny.grid, k) for k in ("sector_res", "azimuth_res")}),
        shapes=dataclasses.replace(cfg.shapes, **{
            k: getattr(tiny.shapes, k) for k in (
                "max_points", "max_clusters", "max_track_points")}),
        gicp=dataclasses.replace(cfg.gicp, xy_extent=tiny.gicp.xy_extent))


def _jax_ec(ec: engine.EngineConfig) -> jengine.EngineConfig:
    """The JAX EngineConfig with `ec`'s fields (ERASOR's included)."""
    fields = {f.name: getattr(ec, f.name) for f in dataclasses.fields(ec)}
    fields["erasor"] = jengine.erasor_mod.ErasorConfig(
        **dataclasses.asdict(ec.erasor))
    fields["desc"] = jscan_context.DescriptorConfig(
        **dataclasses.asdict(ec.desc))
    return jengine.EngineConfig(**fields)


def test_config_matches_jax():
    assert _jax_tiny_cfg() == jconfig.semantickitti().replace(
        grid=dataclasses.replace(jconfig.semantickitti().grid,
                                 sector_res=2.4, azimuth_res=4.0),
        shapes=dataclasses.replace(jconfig.semantickitti().shapes,
                                   max_points=8192, max_clusters=256,
                                   max_track_points=2048),
        gicp=dataclasses.replace(jconfig.semantickitti().gicp,
                                 xy_extent=48.0))
    jec = _jax_ec(engine_scale.long_run_config())
    assert jec.kf_dist == 10.0 and jec.erasor.max_pts_per_bin == 256


def test_budget_error_matches_jax():
    err, kf = engine_scale.budget_case("cpu")
    cfg = _jax_tiny_cfg()
    scene = synthetic.make_scene(synthetic.SceneSpec(
        ground_pts=4000, building_pts=400, tree_pts=100, car_pts=100,
        n_moving_cars=0))
    win = synthetic.render_window(scene, 12, cfg.shapes.max_points)
    ec = jengine.EngineConfig(window=6, max_keyframes=8, submap_points=1024)
    eng = jengine.SlamEngine(cfg, ec)
    with pytest.raises(ValueError, match="keyframe budget") as raised:
        for f in range(12):
            eng.feed(win["xyz"][f], win["intensity"][f], win["valid"][f])
    assert err == str(raised.value)
    assert int((kf >= 0).sum()) == ec.max_keyframes
    np.testing.assert_array_equal(kf, np.asarray(eng.state.kf_frame))


def _jax_false_positive(noise, query=5):
    """tests/test_engine_scale.py:163-190 with `noise` as the poisoned
    submap."""
    cfg = _jax_tiny_cfg()
    scene = synthetic.make_scene(synthetic.SceneSpec(
        ground_pts=6000, building_pts=800, tree_pts=200, car_pts=200,
        n_moving_cars=0))
    F = 6
    win = synthetic.render_window(scene, F, cfg.shapes.max_points)
    ec = jengine.EngineConfig(window=6, max_keyframes=32,
                              submap_points=1024, loop_min_gap=2,
                              loop_min_score=0.9)
    eng = jengine.SlamEngine(cfg, ec)
    for f in range(F):
        eng.feed(win["xyz"][f], win["intensity"][f], win["valid"][f])
    st = eng.state
    st = st.replace(desc=st.desc.at[1].set(st.desc[query]),
                    submap_xyz=st.submap_xyz.at[1].set(jnp.asarray(noise)),
                    submap_valid=st.submap_valid.at[1].set(True))
    xyz = jnp.asarray(win["xyz"])
    valid = jnp.asarray(win["valid"])
    descs = jax.lax.map(
        lambda f: jscan_context.descriptor(xyz[f], valid[f], ec.desc),
        jnp.arange(F))
    slots = jnp.arange(F, dtype=jnp.int32)
    is_kf = jnp.arange(F) == query
    (li, lj, _, _, nl), accepted, pairs, diag = jengine._window_loops(
        st, xyz, valid, descs, slots, is_kf, True, ec, cfg)
    n0 = int(eng.state.n_loops)
    return {"scores": np.asarray(diag[0]), "accepted": np.asarray(accepted),
            "pairs": np.asarray(pairs), "n_loops_before": n0,
            "n_loops": int(nl),
            "new_edges": np.stack([np.asarray(li)[n0:int(nl)],
                                   np.asarray(lj)[n0:int(nl)]], 1)}


def test_false_positive_loop_matches_jax():
    noise = engine_scale.false_positive_noise()
    got = engine_scale.false_positive_case("cpu", noise)
    want = _jax_false_positive(noise)
    # the JAX file's assertions, on the port
    assert got["scores"][0] > 0.95
    assert not got["accepted"][0]
    assert np.all(got["pairs"][0] == -1)
    assert not np.any(got["new_edges"][:, 0] == 1)
    # and the same outcome as the JAX package
    for name in ("accepted", "pairs", "new_edges"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert (got["n_loops_before"], got["n_loops"]) == (
        want["n_loops_before"], want["n_loops"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=SCORE_ATOL)


# ------------------------------------------------- the 96-scan long run


@pytest.fixture(scope="module")
def long_runs(tmp_path_factory):
    """tests/test_engine_scale.py's long run through both packages on the
    same window; the JAX run checkpoints after every window."""
    ckpt_dir = tmp_path_factory.mktemp("jax_windows")
    ec = engine_scale.long_run_config()
    win = engine_scale.long_run_window(engine_scale.tiny_cfg()
                                       .shapes.max_points)
    jeng = jengine.SlamEngine(_jax_tiny_cfg(), _jax_ec(ec))
    ckpts = {}
    for f in range(engine_scale.F_LONG):
        if jeng.feed(win["xyz"][f], win["intensity"][f],
                     win["valid"][f]) is not None:
            ckpts[jeng.windows] = jeng.checkpoint(
                str(ckpt_dir / f"engine_{jeng.windows}"))
    jeng.finalize(final_erasor=True)
    peng = engine.SlamEngine(engine_scale.tiny_cfg(), ec, device="cpu")
    for f in range(engine_scale.F_LONG):
        peng.feed(win["xyz"][f], win["intensity"][f], win["valid"][f])
    peng.finalize(final_erasor=True)
    return win, ec, jeng, peng, ckpts


KF_FIELDS = ("is_kf", "kf_slot", "loop_accepted", "loop_pair")
# measured: 1.32e-2 in window 13, at most 3.2e-3 in the others
STEP_POSE_ATOL = 2e-2
# measured: 231 of window 13's 40,960 points (one cluster's verdict), 0 in
# the others
STEP_REMOVED_FRAC = 0.01


@pytest.mark.slow
def test_long_run_steps_match_jax_from_its_states(long_runs):
    """Every window of the long run stepped by the port from the JAX run's
    state before it (its checkpoint, resumed in the port): the keyframe
    and loop decisions identical in all 19 windows, the poses within
    STEP_POSE_ATOL and `removed` on at most STEP_REMOVED_FRAC of the
    window's points. Window 13 registers against an ill-conditioned local
    map (as window 3 of tests/test_torch_engine.py does): its poses differ
    by 1.3e-2 from the same state, and one moving-car cluster's verdict
    follows them."""
    win, ec, jeng, _, ckpts = long_runs
    cfg = engine_scale.tiny_cfg()
    worst = 0.0
    for k, want in enumerate(jeng.outputs):
        if k == 0:
            eng, lo = engine.SlamEngine(cfg, ec, device="cpu"), 0
        else:
            eng = engine.SlamEngine.resume(ckpts[k], cfg, ec, device="cpu")
            lo = eng.n_frames
        got = None
        for f in range(lo, engine_scale.F_LONG):
            got = eng.feed(win["xyz"][f], win["intensity"][f],
                           win["valid"][f])
            if got is not None:
                break
        for name in KF_FIELDS:
            np.testing.assert_array_equal(
                getattr(got, name), np.asarray(getattr(want, name)),
                err_msg=f"window {k + 1}: {name}")
        n_rm = int((got.removed != np.asarray(want.removed)).sum())
        assert n_rm <= STEP_REMOVED_FRAC * got.removed.size, \
            f"window {k + 1}: removed differs on {n_rm} points"
        worst = max(worst, float(np.abs(got.poses - want.poses).max()))
    print(f"worst window pose difference {worst:.3e}")
    assert worst <= STEP_POSE_ATOL


@pytest.mark.slow
def test_long_run_streams_with_jax(long_runs):
    """The two streaming runs: identical keyframe and loop decisions and
    poses within STREAM_POSE_ATOL through window 10. Each window's
    registrations differ by the last bits of their sums (4e-4 m in window
    1), the ill-conditioned windows carry that to 2e-2 m by window 7, and
    in window 11 a loop verification whose correspondence count sits at
    its floor (264 against 255 for a floor of 256) accepts an edge in the
    JAX run only; from there the runs close different loops. From the
    same state the port takes JAX's decision there
    (test_long_run_steps_match_jax_from_its_states)."""
    _, _, jeng, peng, _ = long_runs
    for k in range(STREAM_WINDOWS):
        want, got = jeng.outputs[k], peng.outputs[k]
        for name in KF_FIELDS:
            np.testing.assert_array_equal(
                getattr(got, name), np.asarray(getattr(want, name)),
                err_msg=f"window {k + 1}: {name}")
        assert float(np.abs(got.poses - np.asarray(want.poses)).max()) \
            <= STREAM_POSE_ATOL, f"window {k + 1}"


@pytest.mark.slow
def test_long_run_holds_the_jax_floors(long_runs):
    """Every floor of tests/test_engine_scale.py on the port's streaming
    run. It misses one on the CPU: after window 11 the run closes 4 loops
    where the JAX run closes 6 (test_long_run_streams_with_jax), and the
    pose graph's ATE is 5.742 m against 0.8 x 6.881 m chained (the JAX run:
    5.492 against 8.873; the card's run of the port: 4.963 against 6.918,
    chip_smoke.py phase 15)."""
    win, ec, _, peng, _ = long_runs
    fl = engine_scale.floors(peng, win)
    print(fl)
    assert engine_scale.missed_floors(fl, ec) == []
