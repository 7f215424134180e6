"""The port's GICP (models/gicp.py) and its se(3) helpers against the JAX
package on the same numpy inputs: voxel maps from a synthetic frame at the
semantickitti() width, and the structured cloud of tests/test_gicp.py.

Tolerances, stated per check (measured on the CPU in brackets):
  * build_voxel_map and pool_voxel_map: identical. Both packages add each
    voxel's points, and each coarse voxel's children, one after another in
    the same order.
  * finalize_target: means and `valid` identical; weights within 1e-4 of
    each voxel's largest weight entry [1.0e-5] (Smith's closed form runs
    through float32 acos/cos, whose last bits differ between XLA and
    PyTorch); voxels whose normal test (weight zeroed) flips are counted
    and bounded at 0.1 % of the valid voxels [0 of 5,183].
  * register and scan_to_scan: every entry of T within 1e-5 [8.1e-7 from
    the same target, 2.1e-7 on the structured cloud]; the [30, N]
    Gauss-Newton sums reduce in another order, so a pass may stop one
    iteration earlier or later: n_iters is not held, n_corr within 1 %.
  * se(3) helpers: 1e-6 absolute (float32 sin/cos).
  * the two drivers of register's outer passes (the host's early exit and
    the device's masked fixed cap): identical, every field.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu.models import gicp as jgicp
from dr_using_scv_od_tpu.ops import geometry as jgeometry
from dr_using_scv_od_tpu.utils import synthetic
from dr_using_scv_od_tpu_torch import config, interop
from dr_using_scv_od_tpu_torch.models import gicp
from dr_using_scv_od_tpu_torch.ops import geometry
from dr_using_scv_od_tpu_torch.utils import timing

T_ATOL = 1e-5
PROFILES = ("semantickitti", "tiny_test")


def _t(a):
    return torch.from_numpy(np.array(a))


def _fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.fixture(scope="module")
def frames():
    win = synthetic.render_window(synthetic.make_scene(), 2,
                                  config.semantickitti().shapes.max_points)
    return win["xyz"], win["valid"]


@pytest.fixture(scope="module")
def maps(frames):
    """{profile: (JAX VoxelMap, port VoxelMap)} of frame 0."""
    xyz, valid = frames
    out = {}
    for profile in PROFILES:
        gcfg = getattr(config, profile)().gicp
        jgcfg = getattr(jconfig, profile)().gicp
        out[profile] = (
            jgicp.build_voxel_map(jnp.asarray(xyz[0]), jnp.asarray(valid[0]),
                                  jgcfg),
            gicp.build_voxel_map(_t(xyz[0]), _t(valid[0]), gcfg))
    return out


def _structured_cloud(rng, n=6000):
    """Ground plane + two walls (tests/test_gicp.py)."""
    g = np.stack([rng.uniform(-20, 20, n // 2), rng.uniform(-20, 20, n // 2),
                  rng.normal(scale=0.02, size=n // 2) - 1.7], 1)
    w1 = np.stack([rng.uniform(-15, 15, n // 4),
                   np.full(n // 4, 8.0) + rng.normal(scale=0.02, size=n // 4),
                   rng.uniform(-1.5, 4, n // 4)], 1)
    w2 = np.stack([np.full(n // 4, -10.0)
                   + rng.normal(scale=0.02, size=n // 4),
                   rng.uniform(-15, 15, n // 4),
                   rng.uniform(-1.5, 4, n // 4)], 1)
    return np.concatenate([g, w1, w2]).astype(np.float32)


def test_se3_helpers_match_jax():
    rng = np.random.default_rng(0)
    xi = rng.normal(scale=0.3, size=(16, 6)).astype(np.float32)
    xi[0] = 0.0                                    # theta = 0
    xi[1, 3:] = 1e-9                               # theta ~ 0
    for jf, tf, arg in ((jgeometry.hat, geometry.hat, xi[:, 3:]),
                        (jgeometry.exp_so3, geometry.exp_so3, xi[:, 3:]),
                        (jgeometry.exp_se3, geometry.exp_se3, xi)):
        np.testing.assert_allclose(tf(_t(arg)).numpy(),
                                   np.asarray(jf(jnp.asarray(arg))),
                                   rtol=0, atol=1e-6)
    T = np.array(jgeometry.exp_se3(jnp.asarray(xi)))
    T[:, :3, :3] += rng.normal(scale=1e-3, size=(16, 3, 3)).astype(
        np.float32)                                # orthogonality defect
    got = geometry.orthonormalize_se3(_t(T)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jgeometry.orthonormalize_se3(jnp.asarray(T))),
        rtol=0, atol=1e-6)
    R = got[:, :3, :3]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-6)


@pytest.mark.parametrize("profile", PROFILES)
def test_build_voxel_map_matches_jax(maps, profile):
    jvm, vm = maps[profile]
    for name in ("n", "sum_x", "sum_xx", "n_oob"):
        np.testing.assert_array_equal(getattr(vm, name).numpy(),
                                      np.asarray(getattr(jvm, name)),
                                      err_msg=name)
    nxy, nz = jgicp._grid_dims(getattr(jconfig, profile)().gicp)
    assert vm.n.shape == (nxy * nxy * nz,) and vm.sum_xx.shape[0] == 6
    assert float(vm.n.sum()) > 0


@pytest.mark.parametrize("factor", [2, 4])
@pytest.mark.parametrize("profile", PROFILES)
def test_pool_voxel_map_matches_jax(maps, profile, factor):
    jvm, vm = maps[profile]
    jp = jgicp.pool_voxel_map(jvm, getattr(jconfig, profile)().gicp, factor)
    p = gicp.pool_voxel_map(vm, getattr(config, profile)().gicp, factor)
    for name in ("n", "sum_x", "sum_xx", "n_oob"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)


def test_pool_voxel_map_rejects_bad_factor(maps):
    with pytest.raises(ValueError):
        gicp.pool_voxel_map(maps["semantickitti"][1],
                            config.semantickitti().gicp, 3)


@pytest.mark.parametrize("level", ["fine", "coarse"])
def test_finalize_target_matches_jax(maps, level):
    jvm, vm = maps["semantickitti"]
    gcfg, jgcfg = config.semantickitti().gicp, jconfig.semantickitti().gicp
    if level == "coarse":
        jvm = jgicp.pool_voxel_map(jvm, jgcfg, 4)
        vm = gicp.pool_voxel_map(vm, gcfg, 4)
        gcfg, jgcfg = gicp._coarse_cfg(gcfg, 4), jgicp._coarse_cfg(jgcfg, 4)
    jt = jgicp.finalize_target(jvm, jgcfg)
    t = gicp.finalize_target(vm, gcfg)
    valid = np.asarray(jt.valid)
    np.testing.assert_array_equal(t.valid.numpy(), valid)
    np.testing.assert_array_equal(t.mean.numpy(), np.asarray(jt.mean))
    jw = np.asarray(jt.weight)[:, valid]
    w = t.weight.numpy()[:, valid]
    zero_j, zero_t = (jw == 0).all(0), (w == 0).all(0)
    flips = int((zero_j != zero_t).sum())
    assert flips <= max(1, valid.sum() // 1000), f"{flips} n_ok flips"
    both = ~zero_j & ~zero_t
    scale = np.abs(jw[:, both]).max(0)
    assert (np.abs(w[:, both] - jw[:, both]) <= 1e-4 * scale).all()


def test_register_from_jax_target(frames):
    """Gauss-Newton alone: the JAX target carried over by interop, frame 1
    registered against frame 0's map."""
    xyz, valid = frames
    jcfg = jconfig.semantickitti().gicp
    jvm = jgicp.build_voxel_map(jnp.asarray(xyz[0]), jnp.asarray(valid[0]),
                                jcfg)
    jt = jgicp.finalize_target(jvm, jcfg)
    jr = jgicp.register(jnp.asarray(xyz[1]), jnp.asarray(valid[1]), jt, jcfg)
    target = interop.gicp_target_from_numpy(_fields(jt), "cpu")
    r = gicp.register(_t(xyz[1]), _t(valid[1]), target,
                      config.semantickitti().gicp)
    np.testing.assert_allclose(r.T.numpy(), np.asarray(jr.T), rtol=0,
                               atol=T_ATOL)
    assert abs(int(r.n_corr) - int(jr.n_corr)) <= 0.01 * int(jr.n_corr)
    assert int(r.n_oob) == int(jr.n_oob)
    assert r.T.dtype == torch.float32 and r.n_iters.dtype == torch.int32


def test_voxel_map_interop_and_merge(maps):
    jvm, vm = maps["tiny_test"]
    got = interop.voxel_map_from_numpy(_fields(jvm), "cpu")
    for name in ("n", "sum_x", "sum_xx", "n_oob"):
        assert torch.equal(getattr(got, name), getattr(vm, name)), name
    merged = got.merge(vm)
    jmerged = jvm.merge(jvm)
    for name in ("n", "sum_x", "sum_xx", "n_oob"):
        np.testing.assert_array_equal(getattr(merged, name).numpy(),
                                      np.asarray(getattr(jmerged, name)))


@pytest.mark.parametrize("pose6", [
    (0.4, 0.1, 0.0, 0.0, 0.0, 0.02),
    (1.0, -0.3, 0.05, 0.01, -0.01, 0.06),
    None,
], ids=["small", "large", "identity"])
def test_scan_to_scan_matches_jax(pose6):
    """tests/test_gicp.py's structured cloud: the port's T equals JAX's and
    meets that file's recovery floors."""
    cfg, jcfg = config.semantickitti().gicp, jconfig.semantickitti().gicp
    target = _structured_cloud(np.random.default_rng(0))
    if pose6 is None:
        T_true = np.eye(4, dtype=np.float32)
        src = target
    else:
        T_true = np.asarray(jgeometry.pose_to_matrix(
            jnp.asarray(pose6, jnp.float32)))
        src = ((target - T_true[:3, 3]) @ T_true[:3, :3]).astype(np.float32)
    valid = np.ones(len(src), bool)
    jr = jgicp.scan_to_scan(jnp.asarray(src), jnp.asarray(valid),
                            jnp.asarray(target), jnp.asarray(valid), jcfg)
    r = gicp.scan_to_scan(_t(src), _t(valid), _t(target), _t(valid), cfg)
    T = r.T.numpy()
    np.testing.assert_allclose(T, np.asarray(jr.T), rtol=0, atol=T_ATOL)
    assert abs(int(r.n_corr) - int(jr.n_corr)) <= 0.01 * int(jr.n_corr)
    assert np.linalg.norm(T[:3, 3] - T_true[:3, 3]) < 0.05
    cos = (np.trace(T[:3, :3] @ T_true[:3, :3].T) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.5
    assert int(r.n_corr) > 1000


def test_register_global_matches_jax():
    """A cold start 1.2 rad of yaw away: the yaw sweep picks the same basin
    as the JAX package's and refines to its T."""
    cfg, jcfg = config.semantickitti().gicp, jconfig.semantickitti().gicp
    target = _structured_cloud(np.random.default_rng(1))
    T_true = np.asarray(jgeometry.pose_to_matrix(
        jnp.asarray((0.5, 0.2, 0.0, 0.0, 0.0, 1.2), jnp.float32)))
    src = ((target - T_true[:3, 3]) @ T_true[:3, :3]).astype(np.float32)
    valid = np.ones(len(src), bool)
    jvm = jgicp.build_voxel_map(jnp.asarray(target), jnp.asarray(valid),
                                jcfg)
    jr = jgicp.register_global(jnp.asarray(src), jnp.asarray(valid), jvm,
                               jcfg, n_yaw=8)
    vm = gicp.build_voxel_map(_t(target), _t(valid), cfg)
    r = gicp.register_global(_t(src), _t(valid), vm, cfg, n_yaw=8)
    np.testing.assert_allclose(r.T.numpy(), np.asarray(jr.T), rtol=0,
                               atol=T_ATOL)


def test_register_targets_reuses_prebuilt_targets(maps, frames):
    """register_pyramid == build_targets + register_targets, and a config
    with no coarse level registers at full resolution only."""
    xyz, valid = frames
    _, vm = maps["semantickitti"]
    cfg = config.semantickitti().gicp
    a = gicp.register_pyramid(_t(xyz[1]), _t(valid[1]), vm, cfg)
    b = gicp.register_targets(_t(xyz[1]), _t(valid[1]),
                              *gicp.build_targets(vm, cfg), cfg)
    assert torch.equal(a.T, b.T)
    flat = dataclasses.replace(cfg, coarse_factor=1)
    tgt_c, ccfg, tgt_f = gicp.build_targets(vm, flat)
    assert tgt_c is None and ccfg is None
    c = gicp.register_targets(_t(xyz[1]), _t(valid[1]), None, None, tgt_f,
                              flat)
    d = gicp.register(_t(xyz[1]), _t(valid[1]), tgt_f, flat)
    assert torch.equal(c.T, d.T)


@pytest.fixture(scope="module")
def moved_pair():
    """The structured cloud and a copy moved 1 m, 0.3 m and 3.4 degrees,
    with the coarse and fine targets of the cloud."""
    cfg = config.semantickitti().gicp
    target = _structured_cloud(np.random.default_rng(2))
    T = geometry.pose_to_matrix(torch.tensor(
        (1.0, -0.3, 0.05, 0.01, -0.01, 0.06))).numpy()
    src = ((target - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    valid = torch.ones(len(src), dtype=torch.bool)
    vm = gicp.build_voxel_map(_t(target), valid, cfg)
    return _t(src), valid, gicp.build_targets(vm, cfg)


@pytest.mark.parametrize("case", ["converges", "cap", "empty"])
def test_device_convergence_equals_the_early_exit(moved_pair, case):
    """converge_on_device, run eagerly on the CPU (no graph), gives
    register's early-exit result bit for bit: a fine pass that stops before
    the cap (from the coarse pose), a coarse one that runs to the cap (from
    the identity), and a target with no valid voxel (a zero step, one
    pass)."""
    src, valid, (tgt_c, ccfg, tgt_f) = moved_pair
    cfg = config.semantickitti().gicp
    T_init = torch.eye(4)
    if case == "converges":
        T_init = gicp.register(src, valid, tgt_c, ccfg).T
        tgt = tgt_f
    elif case == "cap":
        tgt, cfg = tgt_c, ccfg
    else:
        tgt = tgt_f._replace(valid=torch.zeros_like(tgt_f.valid))
    with timing.recording() as rec:
        host = gicp.register(src, valid, tgt, cfg, T_init)
    assert rec.counts == {"gicp.eager": 1}
    xyz, v = gicp._subsample(src, valid, cfg)
    dev = gicp._solve(xyz, v, gicp._target_stack(tgt), tgt.valid, T_init,
                      cfg, gicp.converge_on_device)
    for name in gicp.GicpResult._fields:
        a, b = getattr(host, name), getattr(dev, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    n, cap = int(host.n_iters), gicp._outer_cap(cfg)
    if case == "converges":
        assert 1 < n < cap
    elif case == "cap":
        assert n == cap
    else:
        assert n == 1 and int(host.n_corr) == 0
        assert torch.equal(host.T, geometry.orthonormalize_se3(T_init))
