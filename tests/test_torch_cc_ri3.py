"""The port's kernels 2 and 3 on the CPU, where they run their plain
versions: cc_labels (ops/cc_labels.py) against the JAX
clustering.connected_components, and ri3_labels (ops/ri3_labels.py)
against the JAX models/segmentation.refine_by_intensity run to the
fixpoint (iteration=24, as tests/test_fused_seg.py pins it); the two
identities that tie them to kernel 1; the shared build's cache key; and,
in the slow tier, both against the Pallas TPU kernels in interpret mode.

Tolerance: none. Labels must be identical int32 values - each occupied
voxel the minimum flat id (CC) or minimum input label (RI3) of its
component, each empty voxel its own id. The CUDA kernels themselves are
held against these plain versions on the card by tests/test_torch_cuda.py
and, at full size, by chip_smoke.py."""

import dataclasses
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu.models import segmentation as jseg
from dr_using_scv_od_tpu.ops import clustering as jclustering
from dr_using_scv_od_tpu.types import VoxelGrid
from dr_using_scv_od_tpu_torch.ops import cc_labels as cc
from dr_using_scv_od_tpu_torch.ops import cluster_labels as cl
from dr_using_scv_od_tpu_torch.ops import cuda_build
from dr_using_scv_od_tpu_torch.ops import ri3_labels as ri3

_refine = jax.jit(jseg.refine_by_intensity, static_argnames=("cfg",))


def _cfg_for(shape3, search_c=2, intensity_diff=2.0, far_range_frac=0.6):
    """A JAX config whose curved grid has `shape3` (unit resolution) and
    RI3 pinned to 24 rounds (the fixpoint on these grids)."""
    base = jconfig.tiny_test()
    A, R, S = shape3
    grid = jconfig.GridConfig(min_dis=0.0, max_dis=float(R), range_res=1.0,
                              min_angle=0.0, max_angle=float(S),
                              sector_res=1.0, min_azimuth=0.0,
                              max_azimuth=float(A), azimuth_res=1.0)
    seg = dataclasses.replace(base.seg, iteration=24, search_c=search_c,
                              intensity_diff=intensity_diff,
                              far_range_frac=far_range_frac)
    return dataclasses.replace(base, grid=grid, seg=seg)


def _jax_ri3(occ, av, var, cfg):
    roots = jclustering.connected_components(jnp.asarray(occ))
    grid = VoxelGrid(count=jnp.asarray(occ.reshape(-1).astype(np.int32)),
                     intensity_mean=jnp.asarray(av.reshape(-1)),
                     intensity_var=jnp.asarray(var.reshape(-1)))
    return np.asarray(_refine(roots, grid, cfg=cfg))


def _planes(occ, av, var):
    return (torch.from_numpy(occ.reshape(-1).astype(np.int32)),
            torch.from_numpy(av.reshape(-1)), torch.from_numpy(var.reshape(-1)))


def _port_ri3(occ, av, var, cfg, root=None):
    s = cfg.seg
    if root is None:
        root = cc.cc_labels(torch.from_numpy(occ))
    return ri3.ri3_labels(root, *_planes(occ, av, var), occ.shape,
                          s.search_c, s.intensity_cov, s.intensity_diff,
                          s.far_range_frac).numpy()


# ---- CC: tests/test_cc_pallas.py's cases against the JAX XLA CC

def _cc_case(name):
    if name.startswith("density"):
        shape, density = {"density-a": ((4, 8, 16), 0.3),
                          "density-b": ((12, 16, 24), 0.2),
                          "density-c": ((12, 16, 24), 0.6)}[name]
        return np.random.default_rng(0).random(shape) < density
    if name.startswith("seam"):
        return (np.random.default_rng(int(name[-1]) + 19)
                .random((12, 16, 24)) < 0.35)
    if name == "no-azimuth-wrap":
        occ = np.zeros((12, 16, 24), bool)
        occ[0, 5, 10] = True
        occ[5:10, 5, 10] = True
        return occ
    occ = np.zeros((6, 8, 40), bool)           # the snake
    occ[2, 3, :] = True
    occ[3, 4, 39] = True
    occ[0, 0, 0] = True
    return occ


CC_CASES = ("density-a", "density-b", "density-c", "seam0", "seam1",
            "seam2", "no-azimuth-wrap", "snake")


@pytest.mark.parametrize("name", CC_CASES)
def test_cc_matches_jax(name):
    occ = _cc_case(name)
    got = cc.cc_labels(torch.from_numpy(occ))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jclustering.connected_components(
            jnp.asarray(occ))))
    if name == "no-azimuth-wrap":
        p, x = (np.ravel_multi_index(v, occ.shape)
                for v in ((0, 5, 10), (5, 5, 10)))
        assert got[p] != got[x]


# ---- RI3: fuzz on CC fixpoints, the five semantic cases of
# tests/test_ri3_pallas.py, and search_c = 3

@pytest.mark.parametrize("seed", range(4))
def test_ri3_matches_jax_fuzz(seed):
    """The tiny_test grid of test_ri3_pallas.py's parity fuzz."""
    base = jconfig.tiny_test()
    cfg = dataclasses.replace(
        base, seg=dataclasses.replace(base.seg, iteration=24))
    rng = np.random.default_rng(seed + 77)
    shape3 = cfg.grid.shape
    occ = rng.random(shape3) < 0.06
    av = rng.uniform(0, 12, shape3).astype(np.float32)
    var = rng.uniform(0, 2.5, shape3).astype(np.float32)
    np.testing.assert_array_equal(_port_ri3(occ, av, var, cfg),
                                  _jax_ri3(occ, av, var, cfg))


def _semantic_case(name):
    """(occ, av, var, far_range_frac, must_merge, voxel a, voxel b)."""
    shape3 = (4, 16, 32) if name == "far-range-shrink" else (4, 8, 32)
    occ = np.zeros(shape3, bool)
    av = np.zeros(shape3, np.float32)
    var = np.zeros(shape3, np.float32)
    if name == "qualifying-gap":
        occ[1, 3, 5] = occ[1, 3, 7] = occ[1, 3, 20] = True
        av[1, 3, 5], av[1, 3, 7], av[1, 3, 20] = 100.0, 101.0, 100.0
        return occ, av, var, 1.0, True, (1, 3, 5), (1, 3, 7)
    if name == "bad-variance":
        occ[1, 3, 5] = occ[1, 3, 7] = True
        av[:] = 100.0
        var[1, 3, 5] = var[1, 3, 7] = 50.0
        return occ, av, var, 1.0, False, (1, 3, 5), (1, 3, 7)
    if name == "intensity-differs":
        occ[1, 3, 5] = occ[1, 3, 7] = True
        av[1, 3, 5], av[1, 3, 7] = 100.0, 150.0
        return occ, av, var, 1.0, False, (1, 3, 5), (1, 3, 7)
    if name == "spread-across-cluster":
        occ[1, 3, 2:6] = occ[1, 3, 7:11] = True
        av[1, 3, 2:6], av[1, 3, 7:11] = 100.0, 101.0
        var[1, 3, 3] = var[1, 3, 9] = 99.0
        return occ, av, var, 1.0, True, (1, 3, 2), (1, 3, 10)
    occ[1, 14, 5] = occ[1, 14, 7] = True       # far-range-shrink
    av[:] = 100.0
    return occ, av, var, 0.6, False, (1, 14, 5), (1, 14, 7)


@pytest.mark.parametrize("name", ["qualifying-gap", "bad-variance",
                                  "intensity-differs",
                                  "spread-across-cluster",
                                  "far-range-shrink"])
def test_ri3_semantic_cases_match_jax(name):
    occ, av, var, far, merge, a, b = _semantic_case(name)
    cfg = _cfg_for(occ.shape, far_range_frac=far)
    got = _port_ri3(occ, av, var, cfg)
    ia, ib = (np.ravel_multi_index(v, occ.shape) for v in (a, b))
    assert (got[ia] == got[ib]) == merge
    np.testing.assert_array_equal(got, _jax_ri3(occ, av, var, cfg))


def test_ri3_search_c_3_matches_jax():
    """Every Chebyshev distance 2..3 is in the shell, as in the XLA
    refine_by_intensity and fused_seg.py (ri3_kernel.py:130 visits only
    distance 3 and is not followed). Pairs at cheb 2 and at cheb 3 must
    both merge."""
    shape3 = (6, 16, 48)
    rng = np.random.default_rng(3)
    occ = rng.random(shape3) < 0.05
    occ[2, 4, 10:13] = False
    occ[2, 4, 10] = occ[2, 4, 12] = True               # cheb 2
    occ[3, 8, 20:24] = False
    occ[3, 8, 20] = occ[3, 8, 23] = True               # cheb 3
    av = rng.uniform(0, 4, shape3).astype(np.float32)
    var = rng.uniform(0, 0.5, shape3).astype(np.float32)
    cfg = _cfg_for(shape3, search_c=3, intensity_diff=8.0,
                   far_range_frac=1.0)
    got = _port_ri3(occ, av, var, cfg)
    np.testing.assert_array_equal(got, _jax_ri3(occ, av, var, cfg))
    ix = lambda *c: np.ravel_multi_index(c, shape3)  # noqa: E731
    assert got[ix(2, 4, 10)] == got[ix(2, 4, 12)]
    assert got[ix(3, 8, 20)] == got[ix(3, 8, 23)]


def test_ri3_any_input_takes_min_input_label():
    """On labels that are no CC fixpoint, each occupied voxel gets the
    minimum input label of its component, and no edge joins v to
    root_grid[v]."""
    shape3 = (4, 8, 32)
    occ = np.zeros(shape3, bool)
    occ[1, 3, 5:8] = True                  # one component of three voxels
    occ[2, 6, 20] = True                   # an isolated voxel
    av = np.zeros(shape3, np.float32)
    var = np.zeros(shape3, np.float32)
    cfg = _cfg_for(shape3)
    ix = lambda *c: np.ravel_multi_index(c, shape3)  # noqa: E731
    root = torch.arange(occ.size, dtype=torch.int32)
    root[ix(1, 3, 5)], root[ix(1, 3, 6)], root[ix(1, 3, 7)] = 900, 40, 700
    root[ix(2, 6, 20)] = ix(1, 3, 5)       # points into the component
    got = _port_ri3(occ, av, var, cfg, root=root)
    assert all(got[ix(1, 3, s)] == 40 for s in (5, 6, 7))
    assert got[ix(2, 6, 20)] == ix(1, 3, 5)
    empty = ~occ.reshape(-1)
    np.testing.assert_array_equal(got[empty], np.nonzero(empty)[0])


# ---- the identities of tests/test_fused_seg.py through the plain versions

@pytest.mark.parametrize("seed", range(3))
def test_identities_with_cluster_labels(seed):
    """ri3(cc(occ)) == cluster_labels(occ) and cc(occ) ==
    cluster_labels(occ, enable_shell=False)."""
    shape3 = (6, 16, 64)
    rng = np.random.default_rng(seed + 5)
    occ = rng.random(shape3) < 0.08
    av = rng.uniform(0, 12, shape3).astype(np.float32)
    var = rng.uniform(0, 2.5, shape3).astype(np.float32)
    occ_t = torch.from_numpy(occ)
    count, av_t, var_t = _planes(occ, av, var)
    args = (2, 1.0, 2.0, 0.6)
    np.testing.assert_array_equal(
        ri3.ri3_labels(cc.cc_labels(occ_t), count, av_t, var_t, shape3,
                       *args).numpy(),
        cl.cluster_labels(occ_t, av_t, var_t, *args).numpy())
    np.testing.assert_array_equal(
        cc.cc_labels(occ_t).numpy(),
        cl.cluster_labels(occ_t, av_t, var_t, *args,
                          enable_shell=False).numpy())


def test_dispatch_is_by_device():
    """A CPU tensor takes the plain version and counts no launch; a device
    with no kernel raises instead of falling back."""
    occ = np.random.default_rng(1).random((4, 8, 16)) < 0.3
    occ_t = torch.from_numpy(occ)
    count, av, var = _planes(occ, np.ones(occ.shape, np.float32),
                             np.zeros(occ.shape, np.float32))
    root = cc.cc_labels(occ_t)
    ri3_args = (count, av, var, occ.shape, 2, 1.0, 2.0, 0.6)
    before = (cc.cc_labels.launches, ri3.ri3_labels.launches)
    assert torch.equal(ri3.ri3_labels(root, *ri3_args),
                       ri3.ri3_labels_reference(root, *ri3_args))
    assert (cc.cc_labels.launches, ri3.ri3_labels.launches) == before
    with pytest.raises(ValueError):
        cc.cc_labels(occ_t.to("meta"))
    meta = tuple(a.to("meta") if torch.is_tensor(a) else a
                 for a in (root,) + ri3_args)
    with pytest.raises(ValueError):
        ri3.ri3_labels(*meta)


def test_build_key_covers_every_header(tmp_path, monkeypatch):
    """Editing the shared header, the source or the flags builds anew;
    the other sources' keys move with the header too."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    names = ("cluster_labels", "cc_labels", "ri3_labels")
    before = {n: cuda_build.library_path(n) for n in names}
    assert len(set(before.values())) == 3
    assert all(p.parent == cuda_build.BUILD_DIR for p in before.values())
    header = csrc / "union_find.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    src = csrc / "cc_labels.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert cuda_build.library_path("cc_labels") != after["cc_labels"]
    assert cuda_build.library_path("ri3_labels") == after["ri3_labels"]
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build.library_path("ri3_labels") != after["ri3_labels"]


# ---- slow tier: the Pallas TPU kernels themselves, in interpret mode

@pytest.mark.slow
def test_cc_matches_pallas_interpret():
    from dr_using_scv_od_tpu.ops.pallas import cc_kernel
    occ = np.random.default_rng(19).random((12, 16, 24)) < 0.35
    pallas = np.asarray(cc_kernel.connected_components_pallas(
        jnp.asarray(occ), ab=4, interpret=True))
    np.testing.assert_array_equal(cc.cc_labels(torch.from_numpy(occ)).numpy(),
                                  pallas)


@pytest.mark.slow
def test_ri3_matches_pallas_interpret():
    """search_c = 2, where the TPU kernel's shell and the port's agree.
    Means are drawn on the TPU kernel's 2^-13 fixed-point grid, where its
    integer compare and the port's float compare agree."""
    from dr_using_scv_od_tpu.ops.pallas import ri3_kernel
    shape3 = (6, 16, 64)
    rng = np.random.default_rng(7)
    occ = rng.random(shape3) < 0.08
    av = (rng.integers(0, 12 * 8192, shape3) / 8192.0).astype(np.float32)
    var = rng.uniform(0, 2.5, shape3).astype(np.float32)
    roots = jclustering.connected_components(jnp.asarray(occ))
    pallas = np.asarray(ri3_kernel.refine_by_intensity_pallas(
        roots, jnp.asarray(occ.reshape(-1).astype(np.int32)),
        jnp.asarray(av.reshape(-1)), jnp.asarray(var.reshape(-1)), shape3,
        2, 1.0, 2.0, 0.6, ab=2, interpret=True))
    got = ri3.ri3_labels(torch.from_numpy(np.array(roots)),
                         *_planes(occ, av, var), shape3, 2, 1.0, 2.0, 0.6)
    np.testing.assert_array_equal(got.numpy(), pallas)
