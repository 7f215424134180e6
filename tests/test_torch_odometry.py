"""The port's window odometry (models/odometry.py, posegraph.odometry_chain)
against the JAX package on a reduced synthetic window: F = 3 frames of a
static scene at N = 40,000 points, as tests/test_gicp.py:65-85 builds it,
at the semantickitti() GICP grid.

Tolerances (measured on the CPU in brackets):
  * poses of estimate_window_poses and its scan-to-map variant: every
    entry within 5e-4 [3.3e-5 and 2.5e-5]. Each pair runs two pyramid
    levels of Gauss-Newton whose [30, N] sums reduce in another order than
    XLA's, and a pass may stop one iteration earlier or later; the chain
    composes the differences. The same bound holds the port on the card
    against the port on the CPU (chip_smoke.py; 6.9e-5 measured on an
    H100).
  * n_corr within 1 % per pair [3 of 11,084].
  * ate_rmse and odometry_chain on the same poses: 1e-6 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu.models import odometry as jodometry
from dr_using_scv_od_tpu.models import posegraph as jposegraph
from dr_using_scv_od_tpu.ops import geometry as jgeometry
from dr_using_scv_od_tpu.utils import synthetic
from dr_using_scv_od_tpu_torch import config
from dr_using_scv_od_tpu_torch.models import odometry, posegraph

POSE_ATOL = 5e-4


@pytest.fixture(scope="module")
def window():
    spec = synthetic.SceneSpec(n_moving_cars=0, ground_pts=12000,
                               building_pts=1500, tree_pts=400, car_pts=300)
    return synthetic.render_window(synthetic.make_scene(spec), 3, 40000)


def test_odometry_chain_and_ate_match_jax():
    rng = np.random.default_rng(0)
    xi = rng.normal(scale=0.2, size=(5, 6)).astype(np.float32)
    rel = np.array(jgeometry.exp_se3(jnp.asarray(xi)))
    jposes = np.array(jposegraph.odometry_chain(jnp.asarray(rel)))
    poses = posegraph.odometry_chain(torch.from_numpy(rel))
    assert poses.shape == (6, 4, 4)
    np.testing.assert_array_equal(poses[0].numpy(), np.eye(4))
    np.testing.assert_allclose(poses.numpy(), jposes, rtol=1e-6, atol=1e-6)
    gt = np.array(jposegraph.odometry_chain(jnp.asarray(
        np.asarray(jgeometry.exp_se3(jnp.asarray(xi * 1.1))))))
    np.testing.assert_allclose(
        float(odometry.ate_rmse(torch.from_numpy(jposes),
                                torch.from_numpy(gt))),
        float(jodometry.ate_rmse(jnp.asarray(jposes), jnp.asarray(gt))),
        rtol=1e-6)


@pytest.mark.parametrize("variant", ["estimate_window_poses",
                                     "estimate_window_poses_scan_to_map"])
def test_window_poses_match_jax(window, variant):
    cfg, jcfg = config.semantickitti(), jconfig.semantickitti()
    jres = getattr(jodometry, variant)(jnp.asarray(window["xyz"]),
                                       jnp.asarray(window["valid"]), jcfg)
    res = getattr(odometry, variant)(torch.from_numpy(window["xyz"]),
                                     torch.from_numpy(window["valid"]), cfg)
    assert res.poses.shape == (3, 4, 4) and res.rel_T.shape == (2, 4, 4)
    np.testing.assert_array_equal(res.poses[0].numpy(), np.eye(4))
    for name in ("poses", "rel_T"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)), rtol=0,
                                   atol=POSE_ATOL, err_msg=name)
    n, jn = res.n_corr.numpy(), np.asarray(jres.n_corr)
    assert (np.abs(n - jn) <= 0.01 * jn).all()
    # tests/test_gicp.py's floors: frame f within 0.08 * f metres
    gt = window["poses"]
    for f in range(3):
        err = np.linalg.norm(res.poses[f, :3, 3].numpy() - gt[f][:3, 3])
        assert err < 0.08 * max(f, 1), f"frame {f} ATE {err}"
    ate = float(odometry.ate_rmse(res.poses, torch.from_numpy(gt)))
    jate = float(jodometry.ate_rmse(jres.poses, jnp.asarray(gt)))
    assert abs(ate - jate) < POSE_ATOL
