"""Card-only tests of the port's CUDA kernel (marker `cuda`; they skip
without a GPU). This file imports neither jax nor the JAX package, so it
also runs on a machine that has only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: none. The kernel's labels are an exact fixpoint and must equal
cluster_labels_reference's int32 labels.
"""

import numpy as np
import pytest
import torch

from dr_using_scv_od_tpu_torch import config, interop
from dr_using_scv_od_tpu_torch.models import pipeline
from dr_using_scv_od_tpu_torch.ops import cluster_labels as cl
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
