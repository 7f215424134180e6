"""The port's cluster_labels (ops/cluster_labels.py) against the JAX
package: connected_components + refine_by_intensity run to the fixpoint
(iteration=24, as tests/test_fused_seg.py pins it), and, in the slow tier,
the Pallas kernel in interpret mode.

Tolerance: none. Labels must be identical int32 values - each occupied
voxel the minimum flat id of its component, each empty voxel its own id -
not merely the same partition. The CUDA kernel itself is held against
cluster_labels_reference on the card by tests/test_torch_cuda.py and, at
full size, by chip_smoke.py."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu.models import segmentation as jseg
from dr_using_scv_od_tpu.ops import clustering as jclustering
from dr_using_scv_od_tpu.types import VoxelGrid
from dr_using_scv_od_tpu_torch.ops import cluster_labels as cl
from dr_using_scv_od_tpu_torch.ops import clustering

SHAPE = (6, 16, 64)   # test_fused_seg.py's grids


def _cfg_for(shape3, intensity_diff=2.0, far_range_frac=0.6,
             base=None):
    """A JAX config whose curved grid has `shape3` (unit resolution) and
    RI3 pinned to 24 rounds (the fixpoint on these grids)."""
    base = base or jconfig.tiny_test()
    A, R, S = shape3
    grid = jconfig.GridConfig(min_dis=0.0, max_dis=float(R), range_res=1.0,
                              min_angle=0.0, max_angle=float(S),
                              sector_res=1.0, min_azimuth=0.0,
                              max_azimuth=float(A), azimuth_res=1.0)
    seg = dataclasses.replace(base.seg, iteration=24,
                              intensity_diff=intensity_diff,
                              far_range_frac=far_range_frac)
    return dataclasses.replace(base, grid=grid, seg=seg)


_refine = jax.jit(jseg.refine_by_intensity, static_argnames=("cfg",))


def _jax_labels(occ, av, var, cfg, shell=True):
    roots = jclustering.connected_components(jnp.asarray(occ))
    if not shell:
        return np.asarray(roots)
    grid = VoxelGrid(count=jnp.asarray(occ.reshape(-1).astype(np.int32)),
                     intensity_mean=jnp.asarray(av.reshape(-1)),
                     intensity_var=jnp.asarray(var.reshape(-1)))
    return np.asarray(_refine(roots, grid, cfg=cfg))


def _port_labels(occ, av, var, cfg, shell=True):
    s = cfg.seg
    return cl.cluster_labels(
        torch.from_numpy(occ), torch.from_numpy(av.reshape(-1)),
        torch.from_numpy(var.reshape(-1)), s.search_c, s.intensity_cov,
        s.intensity_diff, s.far_range_frac, enable_shell=shell).numpy()


def _random_grid(seed, shape3, p_occ, av_hi, var_hi):
    rng = np.random.default_rng(seed)
    occ = rng.random(shape3) < p_occ
    av = rng.uniform(0, av_hi, shape3).astype(np.float32)
    var = rng.uniform(0, var_hi, shape3).astype(np.float32)
    return occ, av, var


@pytest.mark.parametrize("shell", [True, False], ids=["shell", "noshell"])
@pytest.mark.parametrize("seed", range(4))
def test_reference_matches_jax_fuzz(seed, shell):
    occ, av, var = _random_grid(seed + 5, SHAPE, 0.08, 12.0, 2.5)
    cfg = _cfg_for(SHAPE)
    np.testing.assert_array_equal(_port_labels(occ, av, var, cfg, shell),
                                  _jax_labels(occ, av, var, cfg, shell))


@pytest.mark.parametrize("seed", range(3))
def test_reference_matches_jax_tiny_config(seed):
    """The tiny_test grid of test_fused_seg.py:117-144, with its
    production RI3 thresholds."""
    base = jconfig.tiny_test()
    cfg = dataclasses.replace(
        base, seg=dataclasses.replace(base.seg, iteration=24))
    occ, av, var = _random_grid(seed + 31, cfg.grid.shape, 0.06, 12.0, 2.5)
    np.testing.assert_array_equal(_port_labels(occ, av, var, cfg),
                                  _jax_labels(occ, av, var, cfg))


@pytest.mark.parametrize("seed", range(4))
def test_multi_tile_seam_fuzz(seed):
    """test_fused_seg.py:51-72: dense grids where every voxel qualifies and
    all means are close, so every shell edge is live."""
    rng = np.random.default_rng(seed + 77)
    occ = rng.random(SHAPE) < 0.25
    av = rng.uniform(0, 4, SHAPE).astype(np.float32)
    var = np.zeros(SHAPE, np.float32)
    cfg = _cfg_for(SHAPE, intensity_diff=8.0, far_range_frac=1.0)
    np.testing.assert_array_equal(_port_labels(occ, av, var, cfg),
                                  _jax_labels(occ, av, var, cfg))


def test_no_azimuth_wraparound():
    """test_fused_seg.py:75-98: voxel (5,5,10) sits 4 azimuth slabs from
    P=(1,5,10) only through a wrap, so the two components stay apart."""
    occ = np.zeros(SHAPE, bool)
    occ[1, 5, 10] = True
    occ[5, 5, 10] = True
    occ[4, 5, 10:14] = True
    occ[3, 5, 13] = True
    av = np.full(SHAPE, 2.0, np.float32)
    var = np.zeros(SHAPE, np.float32)
    cfg = _cfg_for(SHAPE, intensity_diff=8.0, far_range_frac=1.0)
    lab = _port_labels(occ, av, var, cfg)
    p = np.ravel_multi_index((1, 5, 10), SHAPE)
    land = np.ravel_multi_index((3, 5, 13), SHAPE)
    assert lab[p] != lab[land], "azimuth wrap merged distant components"
    np.testing.assert_array_equal(lab, _jax_labels(occ, av, var, cfg))


@pytest.mark.parametrize("shell", [True, False], ids=["shell", "noshell"])
def test_no_sector_or_range_wraparound(shell):
    """Voxels at cheb 1 and 2 across the sector seam (s = 0 and S-1,
    s = 1 and S-2) and across the range ends stay separate components:
    no axis wraps (clustering.py:16-19)."""
    A, R, S = SHAPE
    occ = np.zeros(SHAPE, bool)
    pairs = [((1, 3, 0), (1, 3, S - 1)), ((4, 10, 1), (4, 10, S - 2)),
             ((2, 0, 30), (2, R - 1, 30))]
    for u, v in pairs:
        occ[u] = occ[v] = True
    av = np.full(SHAPE, 2.0, np.float32)
    var = np.zeros(SHAPE, np.float32)
    cfg = _cfg_for(SHAPE, intensity_diff=8.0, far_range_frac=1.0)
    lab = _port_labels(occ, av, var, cfg, shell)
    for u, v in pairs:
        iu, iv = (np.ravel_multi_index(x, SHAPE) for x in (u, v))
        assert lab[iu] == iu and lab[iv] == iv
    np.testing.assert_array_equal(lab, _jax_labels(occ, av, var, cfg, shell))


def test_gated_edge_needs_both_ends_occupied():
    """Two occupied voxels at cheb 3 with an empty voxel between: the
    empty cell is no conduit (fused_seg.py:171-176), so no merge; the
    same pair at cheb 2 merges."""
    occ = np.zeros(SHAPE, bool)
    occ[2, 4, 10] = occ[2, 4, 13] = True          # cheb 3 apart
    occ[2, 8, 20] = occ[2, 8, 22] = True          # cheb 2 apart
    av = np.full(SHAPE, 2.0, np.float32)
    var = np.zeros(SHAPE, np.float32)
    cfg = _cfg_for(SHAPE, intensity_diff=8.0, far_range_frac=1.0)
    lab = _port_labels(occ, av, var, cfg)
    ix = lambda *c: np.ravel_multi_index(c, SHAPE)  # noqa: E731
    assert lab[ix(2, 4, 13)] == ix(2, 4, 13)
    assert lab[ix(2, 8, 22)] == ix(2, 8, 20)


def test_connected_components_matches_jax():
    occ, _, _ = _random_grid(11, (4, 12, 40), 0.15, 1.0, 1.0)
    np.testing.assert_array_equal(
        clustering.connected_components(torch.from_numpy(occ)).numpy(),
        np.asarray(jclustering.connected_components(jnp.asarray(occ))))


def test_dispatch_is_by_device():
    """A CPU tensor takes the plain version; a device with no kernel
    raises instead of falling back."""
    occ, av, var = _random_grid(3, SHAPE, 0.08, 12.0, 2.5)
    args = (torch.from_numpy(occ), torch.from_numpy(av.reshape(-1)),
            torch.from_numpy(var.reshape(-1)), 2, 1.0, 2.0, 0.6)
    before = cl.cluster_labels.launches
    assert torch.equal(cl.cluster_labels(*args),
                       cl.cluster_labels_reference(*args))
    assert cl.cluster_labels.launches == before
    meta = tuple(a.to("meta") if torch.is_tensor(a) else a for a in args)
    with pytest.raises(ValueError):
        cl.cluster_labels(*meta)


@pytest.mark.slow
@pytest.mark.parametrize("shell", [True, False], ids=["shell", "noshell"])
def test_reference_matches_pallas_interpret(shell):
    """Against the TPU kernel itself in interpret mode. Means are drawn on
    its 2^-13 fixed-point grid, where its integer compare and the port's
    float compare agree."""
    from dr_using_scv_od_tpu.ops.pallas import fused_seg
    rng = np.random.default_rng(7)
    occ = rng.random(SHAPE) < 0.08
    av = (rng.integers(0, 12 * 8192, SHAPE) / 8192.0).astype(np.float32)
    var = rng.uniform(0, 2.5, SHAPE).astype(np.float32)
    pallas = np.asarray(fused_seg.cluster_labels_pallas(
        jnp.asarray(occ), jnp.asarray(av.reshape(-1)),
        jnp.asarray(var.reshape(-1)), 2, 1.0, 2.0, far_range_frac=0.6,
        enable_shell=shell, ab=2, interpret=True))
    np.testing.assert_array_equal(
        _port_labels(occ, av, var, _cfg_for(SHAPE), shell), pallas)
