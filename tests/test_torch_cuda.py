"""Card-only tests of the port's CUDA kernels and of GICP on the card
(marker `cuda`; they skip without a GPU). This file imports neither jax
nor the JAX package, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: none for labels. The three kernels compute exact fixpoints and
must equal their plain versions' int32 labels in every launch. Poses of
`register` on the card against the port's CPU run: 5e-4 absolute on every
entry of T (the [30, N] sums reduce in another order on the card; the port
and the JAX package differ by < 1e-6 on these clouds,
tests/test_torch_gicp.py).
"""

import numpy as np
import pytest
import torch

from dr_using_scv_od_tpu_torch import config, interop
from dr_using_scv_od_tpu_torch.models import gicp, pipeline
from dr_using_scv_od_tpu_torch.ops import cc_labels as cc
from dr_using_scv_od_tpu_torch.ops import cluster_labels as cl
from dr_using_scv_od_tpu_torch.ops import clustering
from dr_using_scv_od_tpu_torch.ops import ri3_labels as ri3
from dr_using_scv_od_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda

SHAPE = (6, 16, 64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _grid(seed, device, p_occ=0.08):
    rng = np.random.default_rng(seed)
    occ = rng.random(SHAPE) < p_occ
    av = rng.uniform(0, 12, SHAPE).astype(np.float32).reshape(-1)
    var = rng.uniform(0, 2.5, SHAPE).astype(np.float32).reshape(-1)
    return [torch.from_numpy(a).to(device) for a in (occ, av, var)]


@pytest.mark.parametrize("shell", [True, False], ids=["shell", "noshell"])
@pytest.mark.parametrize("seed", range(8))
def test_kernel_matches_reference(cuda_device, seed, shell):
    """Every one of 20 launches: the atomics run in another order each
    time, and a race shows as an occasional wrong voxel."""
    args = _grid(seed, cuda_device) + [2, 1.0, 2.0, 0.6, shell]
    want = cl.cluster_labels_reference(*args)
    before = cl.cluster_labels.launches
    for _ in range(20):
        got = cl.cluster_labels(*args)
        assert got.dtype == torch.int32 and got.device == cuda_device
        assert torch.equal(got, want)
    assert cl.cluster_labels.launches == before + 20


def test_kernel_rejects_bad_inputs(cuda_device):
    occ, av, var = _grid(0, cuda_device)
    with pytest.raises(TypeError):
        cl.cluster_labels(occ, av.double(), var, 2, 1.0, 2.0, 0.6)
    with pytest.raises(ValueError):
        cl.cluster_labels(occ, av.cpu(), var, 2, 1.0, 2.0, 0.6)
    with pytest.raises(ValueError):
        cl.cluster_labels(occ, av[:-1], var, 2, 1.0, 2.0, 0.6)


def test_run_window_on_card_matches_cpu(cuda_device):
    """tiny_test() window: the CUDA run and the CPU run of the port agree
    on the removed mask and the label grids."""
    cfg = config.tiny_test()
    spec = synthetic.SceneSpec(ground_pts=1200, building_pts=200,
                               tree_pts=80, car_pts=120, n_buildings=2,
                               n_trees=2, n_parked_cars=2, n_moving_cars=1,
                               extent=14.0)
    win = synthetic.render_window(synthetic.make_scene(spec), 3,
                                  cfg.shapes.max_points)
    before = cl.cluster_labels.launches
    gpu = pipeline.run_window(*interop.window_from_numpy(win, cuda_device),
                              cfg)
    assert cl.cluster_labels.launches == before + 3
    cpu = pipeline.run_window(*interop.window_from_numpy(win, "cpu"), cfg)
    assert torch.equal(gpu.removed.cpu(), cpu.removed)
    assert torch.equal(gpu.label_grids.cpu(), cpu.label_grids)


@pytest.mark.parametrize("seed", range(8))
def test_cc_kernel_matches_reference(cuda_device, seed):
    occ = _grid(seed, cuda_device, p_occ=0.25)[0]
    want = clustering.connected_components(occ)
    before = cc.cc_labels.launches
    for _ in range(20):
        got = cc.cc_labels(occ)
        assert got.dtype == torch.int32 and got.device == cuda_device
        assert torch.equal(got, want)
    assert cc.cc_labels.launches == before + 20


@pytest.mark.parametrize("labels", ["cc-fixpoint", "permuted"])
@pytest.mark.parametrize("seed", range(8))
def test_ri3_kernel_matches_reference(cuda_device, seed, labels):
    """On a connected-components fixpoint, and on arbitrary input labels
    (each occupied voxel then gets its component's minimum input label)."""
    occ, av, var = _grid(seed, cuda_device)
    if labels == "cc-fixpoint":
        root = clustering.connected_components(occ)
    else:
        gen = torch.Generator().manual_seed(seed)
        root = torch.randperm(occ.numel(), generator=gen).int().to(
            cuda_device)
    args = (root, occ.reshape(-1).int(), av, var, SHAPE, 2, 1.0, 2.0, 0.6)
    want = ri3.ri3_labels_reference(*args)
    before = ri3.ri3_labels.launches
    for _ in range(20):
        got = ri3.ri3_labels(*args)
        assert got.dtype == torch.int32 and got.device == cuda_device
        assert torch.equal(got, want)
    assert ri3.ri3_labels.launches == before + 20
    if labels == "cc-fixpoint":
        assert torch.equal(got, cl.cluster_labels(occ, av, var, 2, 1.0, 2.0,
                                                  0.6))


def test_cc_ri3_kernels_reject_bad_inputs(cuda_device):
    occ, av, var = _grid(0, cuda_device)
    count = occ.reshape(-1).int()
    root = clustering.connected_components(occ)
    with pytest.raises(TypeError):
        cc.cc_labels(occ.int())
    with pytest.raises(ValueError):
        cc.cc_labels(occ.reshape(-1))
    with pytest.raises(TypeError):
        ri3.ri3_labels(root.long(), count, av, var, SHAPE, 2, 1.0, 2.0, 0.6)
    with pytest.raises(ValueError):
        ri3.ri3_labels(root, count.cpu(), av, var, SHAPE, 2, 1.0, 2.0, 0.6)
    with pytest.raises(ValueError):
        ri3.ri3_labels(root, count, av[:-1], var, SHAPE, 2, 1.0, 2.0, 0.6)


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


def test_register_on_card_matches_cpu(cuda_device):
    cfg = config.semantickitti().gicp
    target = _structured_cloud(np.random.default_rng(0))
    c, s = np.cos(0.06), np.sin(0.06)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    src = ((target - np.array([1.0, -0.3, 0.05], np.float32)) @ R
           ).astype(np.float32)
    valid = np.ones(len(src), bool)

    def run(device):
        t = [torch.from_numpy(a).to(device)
             for a in (src, valid, target, valid)]
        return gicp.scan_to_scan(*t, cfg)

    gpu, cpu = run(cuda_device), run("cpu")
    assert gpu.T.device == cuda_device
    assert float((gpu.T.cpu() - cpu.T).abs().max()) < 5e-4
    assert abs(int(gpu.n_corr) - int(cpu.n_corr)) <= 0.01 * int(cpu.n_corr)
