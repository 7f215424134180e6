"""Card-only tests of the port's CUDA kernels and of GICP on the card
(marker `cuda`; they skip without a GPU). This file imports neither jax
nor the JAX package, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: none for labels. The three kernels compute exact fixpoints and
must equal their plain versions' int32 labels in every launch, on random
grids and on the seam grids of their tile plan (ops/tile_plan.seam_grids)
at a grid whose every side is clipped; kernel 2 also on a ragged full-size
grid (61 x 75 x 301) and on adversarial occupancies. Poses of
`register` on the card against the port's CPU run: 5e-4 absolute on every
entry of T (the [30, N] sums reduce in another order on the card; the port
and the JAX package differ by < 1e-6 on these clouds,
tests/test_torch_gicp.py).

Bin edges (tests/torch_bin_edges.py): points on every edge of the curved
grid (sector, range, azimuth), of patchwork's rings, sectors and z
histogram, of scan context's and ERASOR's rings and sectors and of the
GICP voxels bin identically on the card and the CPU: a division by a
Python scalar on the card multiplies by its reciprocal and would not.
Points whose atan2 rounds otherwise on the card (a last-bit difference of
the device's atan2, not of the binning) are left out and counted.

`pipeline.segdf_window` (`cli segdf --estimate-poses`) on the card: its
estimated poses within 5e-4 of the CPU's and the same removed mask.

The evaluation subcommands (`evaluate`, `evaluate-map`, `erasor`) print
the same lines on the card as with `--device cpu`, with PyTorch's default
float32 matmul precision (no TF32).

Slice F's parts on the card: voxel_downsample's keep-mask equals the
CPU's (points on leaf edges included), refine_by_intensity at 24 rounds
equals kernel 1, and the stage profiler's segment_reduce split reads a
device time.

`cli slam --data`'s scan stream: by default it down-samples on the card,
and its scans equal the host's numpy down-sample and padding bit for bit
(points on leaf edges, far out, infinite and NaN among them); it counts
every scan as `scan.leaf_card` and syncs once a scan inside `downsample`.

GICP as a CUDA graph: `register` on the card (one captured solve per
shape, replayed) equals the eager early-exit loop on the card bit for bit,
at 32,768 and 4,096 source points against both pyramid levels, and with
two targets through one cached graph; `exp_se3`, `inverse_se3` and
`register` (capture and replay) raise nothing under the sync debug mode
"error"; a recording counts each call's path.

The SLAM engine's parts: two runs on the card are identical (no scatter of
the engine path adds floats through atomics); `posegraph.optimize` on the
card agrees with the CPU within 1e-4 where its CG converges, ERASOR's
`clean_map` exactly, and one engine window within 5e-4 on the poses,
identical keyframe integers and `removed` on at most 0.1 % of the valid
points.
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch
import torch_bin_edges as edges

from dr_using_scv_od_tpu_torch import cli, config, interop
from dr_using_scv_od_tpu_torch.eval import artifact
from dr_using_scv_od_tpu_torch.models import (engine, erasor, gicp, patchwork,
                                              pipeline, posegraph,
                                              scan_context, segmentation)
from dr_using_scv_od_tpu_torch.ops import geometry, quantize, segment_ops
from dr_using_scv_od_tpu_torch.ops import cc_labels as cc
from dr_using_scv_od_tpu_torch.ops import cluster_labels as cl
from dr_using_scv_od_tpu_torch.ops import clustering
from dr_using_scv_od_tpu_torch.ops import ri3_labels as ri3
from dr_using_scv_od_tpu_torch.ops import tile_plan
from dr_using_scv_od_tpu_torch.tools import kernel_times, profile_stages
from dr_using_scv_od_tpu_torch.types import VoxelGrid
from dr_using_scv_od_tpu_torch.utils import (io_kitti, prefetch, synthetic,
                                             timing)

pytestmark = pytest.mark.cuda

SHAPE = (6, 16, 64)
SEAM_SHAPE = (13, 21, 75)    # no side a multiple of the 4 x 8 x 32 tile
SEAM_CASES = ["snake-S", "snake-R", "snake-A", "faces", "dense60", "corners"]


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


@pytest.mark.parametrize("search_c", [2, 3])
@pytest.mark.parametrize("case", SEAM_CASES)
def test_tiled_kernels_match_reference_on_seam_grids(cuda_device, case,
                                                     search_c):
    """Kernels 1 and 3 in each of 20 launches on the seam grids of their
    tile plan; at search_c 3 the seam pass asks for more than 48 KB of
    shared memory."""
    cases = tile_plan.seam_grids(SEAM_SHAPE, search_c, 1.0, 2.0)
    name, occ, av, var = cases[SEAM_CASES.index(case)]
    assert name == case
    occ3, av, var = (torch.from_numpy(a).to(cuda_device)
                     for a in (occ, av, var))
    args = (occ3, av, var, search_c, 1.0, 2.0, 0.6)
    want = cl.cluster_labels_reference(*args)
    root = clustering.connected_components(occ3)
    rargs = (root, occ3.reshape(-1).int(), av, var, SEAM_SHAPE, search_c,
             1.0, 2.0, 0.6)
    want3 = ri3.ri3_labels_reference(*rargs)
    before = (cl.cluster_labels.launches, ri3.ri3_labels.launches)
    for _ in range(20):
        assert torch.equal(cl.cluster_labels(*args), want)
        assert torch.equal(ri3.ri3_labels(*rargs), want3)
    assert (cl.cluster_labels.launches, ri3.ri3_labels.launches) == (
        before[0] + 20, before[1] + 20)
    assert torch.equal(want3, want)


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


def test_segdf_window_on_card_matches_cpu(cuda_device):
    """`cli segdf --estimate-poses`'s entry at full width on chip_smoke.py
    phase 8's 4-frame window: the card's estimated poses within 5e-4 of
    the CPU's (chip_smoke.POSE_ATOL) and the same removed mask."""
    cfg = config.semantickitti()
    win = synthetic.render_window(synthetic.make_scene(synthetic.SceneSpec()),
                                  4, cfg.shapes.max_points)
    got = [pipeline.segdf_window(*interop.window_from_numpy(win, dev), cfg,
                                 estimate_poses=True)
           for dev in (cuda_device, "cpu")]
    gap = float((got[0].poses.cpu() - got[1].poses).abs().max())
    assert gap < 5e-4
    assert torch.equal(got[0].window.removed.cpu(), got[1].window.removed)
    assert int(got[1].window.removed.sum()) > 0


@pytest.fixture
def fresh_patchwork_graphs(monkeypatch):
    """An empty cache of captured patchwork calls for the test."""
    graphs = patchwork._Graphs(patchwork.MAX_GRAPHS)
    monkeypatch.setattr(patchwork, "GRAPHS", graphs)
    return graphs


@pytest.fixture(scope="module")
def patchwork_frames():
    """Frames 0, 1 and 2 of a rendered full-width window on the CPU."""
    cfg = config.semantickitti()
    win = synthetic.render_window(synthetic.make_scene(synthetic.SceneSpec()),
                                  3, cfg.shapes.max_points)
    xyz, _, valid, _ = interop.window_from_numpy(win, "cpu")
    return xyz, valid, cfg.patchwork


def _assert_same_ground(a, b):
    for name in patchwork.PatchworkResult._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), name


def test_patchwork_graph_equals_eager_on_card(cuda_device, patchwork_frames,
                                              fresh_patchwork_graphs):
    """One captured call serves three frames in turn, each equal bit for
    bit to the eager ops on the card; against the CPU's, the same masks
    and the patch planes within float32 rounding."""
    xyz, valid, pw = patchwork_frames
    for f in (0, 1, 2, 0):
        x, v = xyz[f].to(cuda_device), valid[f].to(cuda_device)
        got = patchwork.estimate_ground(x, v, pw)
        _assert_same_ground(got, patchwork._estimate_ground(x, v, pw))
        cpu = patchwork.estimate_ground(xyz[f], valid[f], pw)
        for name in ("ground", "nonground", "dropped"):
            assert torch.equal(getattr(got, name).cpu(), getattr(cpu, name))
        for name in ("patch_normal", "patch_mean_z"):
            torch.testing.assert_close(getattr(got, name).cpu(),
                                       getattr(cpu, name), rtol=0,
                                       atol=1e-4)
        assert int(got.ground.sum()) > 1000
    assert len(fresh_patchwork_graphs.graphs) == 1


def test_patchwork_makes_no_host_sync(cuda_device, patchwork_frames,
                                      fresh_patchwork_graphs):
    xyz, valid, pw = patchwork_frames
    x, v = xyz[0].to(cuda_device), valid[0].to(cuda_device)
    patchwork.estimate_ground(x, v, pw)                 # capture, replay
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = patchwork.estimate_ground(x, v, pw)       # replay
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert int(got.ground.sum()) > 1000


def test_patchwork_recording_counts_the_path_of_each_call(
        cuda_device, patchwork_frames, monkeypatch):
    """With room for one captured call: the first call captures and
    replays it, the second replays it, another point count runs eagerly;
    each counts the segment sums of one eager call."""
    xyz, valid, pw = patchwork_frames
    x, v = xyz[0].to(cuda_device), valid[0].to(cuda_device)
    half = (x[::2].contiguous(), v[::2].contiguous())
    monkeypatch.setattr(patchwork, "GRAPHS", patchwork._Graphs(1))
    sums = []
    with timing.recording() as rec:
        for args in ((x, v), (x, v), half):
            before = segment_ops.segment_sum.launches
            patchwork.estimate_ground(*args, pw)
            sums.append(segment_ops.segment_sum.launches - before)
    before = segment_ops.segment_sum.launches
    patchwork._estimate_ground(x, v, pw)
    eager = segment_ops.segment_sum.launches - before
    assert sums == [eager, eager, eager] and eager >= 4
    assert rec.counts["patchwork.graph"] == 2
    assert rec.counts["patchwork.eager"] == 1
    assert rec.counts["segment_sum.card"] == 3 * eager


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


def _hold_cc(occ, device, launches=10):
    occ3 = torch.as_tensor(occ, device=device)
    want = clustering.connected_components(occ3)
    before = cc.cc_labels.launches
    for _ in range(launches):
        got = cc.cc_labels(occ3)
        assert got.dtype == torch.int32 and got.device == device
        assert torch.equal(got, want)
    assert cc.cc_labels.launches == before + launches
    return occ3, want


@pytest.mark.parametrize("case", SEAM_CASES)
def test_cc_kernel_matches_reference_on_seam_grids(cuda_device, case):
    """Kernel 2 in each of 10 launches on the seam grids of its radius-1
    tile plan, and the identity with kernel 1 without the shell."""
    cases = tile_plan.seam_grids(SEAM_SHAPE, 1, 1.0, 2.0)
    name, occ, av, var = cases[SEAM_CASES.index(case)]
    assert name == case
    occ3, want = _hold_cc(occ, cuda_device)
    av, var = (torch.from_numpy(a).to(cuda_device) for a in (av, var))
    assert torch.equal(want, cl.cluster_labels(occ3, av, var, 2, 1.0, 2.0,
                                               0.6, enable_shell=False))


@pytest.mark.parametrize("density", [0.007, 0.2, 0.6])
def test_cc_kernel_on_a_ragged_full_size_grid(cuda_device, density):
    """61 x 75 x 301: every axis ends in a clipped tile."""
    rng = np.random.default_rng(int(density * 1000))
    _hold_cc(rng.random((61, 75, 301)) < density, cuda_device)


def _adversarial_occupancies():
    shape = (9, 19, 70)
    full = np.ones(shape, bool)
    checker = np.indices(shape).sum(0) % 2 == 0
    # alternate voxels along S on alternate rows: every union is a
    # diagonal one between runs of length 1
    combs = np.zeros(shape, bool)
    combs[:, ::2, ::2] = True
    combs[:, 1::2, 1::2] = True
    stairs = np.zeros(shape, bool)
    for i in range(70):
        stairs[i % 9, i % 19, i] = True
    gaps = np.zeros(shape, bool)        # runs facing the gaps of the next row
    gaps[:, ::2, :] = np.arange(70) % 4 < 2
    gaps[:, 1::2, :] = np.arange(70) % 4 == 3
    column = np.zeros(shape, bool)
    column[:, 7, 31:33] = True          # across the S tile border
    return {"full": full, "empty": ~full, "checker": checker,
            "combs": combs, "stairs": stairs, "gaps": gaps,
            "column": column}


@pytest.mark.parametrize("case", ["full", "empty", "checker", "combs",
                                  "stairs", "gaps", "column"])
def test_cc_kernel_on_adversarial_grids(cuda_device, case):
    _hold_cc(_adversarial_occupancies()[case], cuda_device)


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
        fused = cl.cluster_labels(occ, av, var, 2, 1.0, 2.0, 0.6)
        assert torch.equal(got, fused)
        assert torch.equal(ri3.ri3_labels(cc.cc_labels(occ), *args[1:]),
                           fused)


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


@pytest.fixture(scope="module")
def gicp_scans():
    """Two full-width synthetic scans on the card and the coarse and fine
    targets of each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs exist only there")
    dev = torch.device("cuda", 0)
    cfg = config.semantickitti()
    win = synthetic.render_window(synthetic.make_scene(), 3,
                                  cfg.shapes.max_points)
    xyz = torch.from_numpy(win["xyz"]).to(dev)
    valid = torch.from_numpy(win["valid"]).to(dev)
    targets = [gicp.build_targets(gicp.build_voxel_map(xyz[f], valid[f],
                                                       cfg.gicp), cfg.gicp)
               for f in (0, 2)]
    return xyz, valid, targets, cfg.gicp


@pytest.fixture
def fresh_graphs(monkeypatch):
    """An empty cache of captured solves for the test."""
    graphs = gicp._Graphs(gicp.MAX_GRAPHS)
    monkeypatch.setattr(gicp, "GRAPHS", graphs)
    return graphs


def _source(xyz, valid, points):
    """Frame 1 as 131,072 points (32,768 after register's subsample) or
    every 32nd point (4,096, a loop submap's size)."""
    if points == 32768:
        return xyz[1], valid[1]
    return xyz[1][::32].contiguous(), valid[1][::32].contiguous()


def _eager(xyz, valid, target, cfg, T_init):
    """The early-exit loop on the card, with its host read per pass."""
    xyz, valid = gicp._subsample(xyz, valid, cfg)
    return gicp._solve(xyz, valid, gicp._target_stack(target), target.valid,
                       T_init, cfg, gicp.converge_on_host)


def _level(targets, level, cfg):
    tgt_c, ccfg, tgt_f = targets
    return (tgt_c, ccfg) if level == "coarse" else (tgt_f, cfg)


def _assert_same(a, b):
    for name in gicp.GicpResult._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize("level", ["coarse", "fine"])
@pytest.mark.parametrize("points", [32768, 4096])
def test_register_graph_equals_eager_on_card(gicp_scans, fresh_graphs,
                                             points, level):
    xyz, valid, targets, cfg = gicp_scans
    src, sv = _source(xyz, valid, points)
    tgt, c = _level(targets[0], level, cfg)
    T_init = geometry.pose_to_matrix(torch.tensor(
        (0.3, -0.1, 0.0, 0.0, 0.0, 0.02), device=xyz.device))
    if level == "fine":        # from the coarse pose: stops before the cap
        tgt_c, ccfg, _ = targets[0]
        T_init = _eager(src, sv, tgt_c, ccfg, T_init).T
    first = gicp.register(src, sv, tgt, c, T_init)      # capture, replay
    again = gicp.register(src, sv, tgt, c, T_init)      # replay
    eager = _eager(src, sv, tgt, c, T_init)
    assert len(fresh_graphs.graphs) == 1
    _assert_same(first, eager)
    _assert_same(again, eager)
    n, cap = int(eager.n_iters), gicp._outer_cap(c)
    print(points, level, "passes", n, "of", cap, "n_corr",
          int(eager.n_corr))
    assert int(eager.n_corr) > 100
    assert n == cap if level == "coarse" else n < cap


@pytest.mark.parametrize("level", ["coarse", "fine"])
def test_one_graph_serves_two_targets(gicp_scans, fresh_graphs, level):
    """The static buffers are refilled on each call: two targets (frames 0
    and 2) and two starts through one cached graph give each call's own
    eager result."""
    xyz, valid, targets, cfg = gicp_scans
    src, sv = _source(xyz, valid, 32768)
    calls = []
    for k, yaw in ((0, 0.0), (1, 0.05), (0, 0.05), (1, 0.0)):
        tgt, c = _level(targets[k], level, cfg)
        T_init = geometry.pose_to_matrix(torch.tensor(
            (0.2, 0.0, 0.0, 0.0, 0.0, yaw), device=xyz.device))
        calls.append((gicp.register(src, sv, tgt, c, T_init),
                      _eager(src, sv, tgt, c, T_init)))
    assert len(fresh_graphs.graphs) == 1
    for got, want in calls:
        _assert_same(got, want)
    assert not torch.equal(calls[0][0].T, calls[1][0].T)


def test_register_makes_no_host_sync(gicp_scans, fresh_graphs):
    xyz, valid, targets, cfg = gicp_scans
    tgt_c, ccfg, _ = targets[0]
    xi = torch.randn(16, 6, device=xyz.device) * 0.1
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T = geometry.exp_se3(xi)
        geometry.inverse_se3(T)
        geometry.orthonormalize_se3(T)
        for _ in range(2):                          # capture, then replay
            res = gicp.register(xyz[1], valid[1], tgt_c, ccfg, T[0])
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert int(res.n_iters) >= 1


def test_recording_counts_the_path_of_each_call(gicp_scans, monkeypatch):
    """With room for one captured solve: the first call captures and
    replays it, the second replays it, a second shape runs eagerly."""
    xyz, valid, targets, cfg = gicp_scans
    tgt_c, ccfg, tgt_f = targets[0]
    monkeypatch.setattr(gicp, "GRAPHS", gicp._Graphs(1))
    with timing.recording() as rec:
        gicp.register(xyz[1], valid[1], tgt_c, ccfg)
        after_first = dict(rec.counts)
        gicp.register(xyz[1], valid[1], tgt_c, ccfg)
        after_second = dict(rec.counts)
        eager = gicp.register(xyz[1], valid[1], tgt_f, cfg)
    assert after_first == {"gicp.graph": 1}
    assert after_second == {"gicp.graph": 2}
    assert rec.counts == {"gicp.graph": 2, "gicp.eager": 1}
    _assert_same(eager, _eager(xyz[1], valid[1], tgt_f, cfg, torch.eye(
        4, device=xyz.device)))


def _square_graph():
    """tests/test_posegraph.py's noisy square with its closing edge, built
    with the port on the CPU."""
    rng = np.random.default_rng(0)
    F, n_side = 20, 5
    true, noisy = [], []
    for k in range(F - 1):
        xi = np.zeros(6, np.float32)
        xi[0] = 1.0
        if (k + 1) % n_side == 0:
            xi[5] = np.pi / 2
        dxi = np.concatenate([rng.normal(scale=0.05, size=3),
                              rng.normal(scale=0.01, size=3)])
        rel = geometry.exp_se3(torch.from_numpy(xi))
        true.append(rel)
        noisy.append(geometry.exp_se3(torch.from_numpy(
            dxi.astype(np.float32))) @ rel)
    gt = posegraph.odometry_chain(torch.stack(true))
    rels = torch.stack(noisy)
    T_loop = geometry.inverse_se3(gt[F - 1]) @ gt[0]
    return posegraph.make_odometry_graph(
        posegraph.odometry_chain(rels), rels,
        loop_i=torch.tensor([F - 1]), loop_j=torch.tensor([0]),
        loop_T=T_loop[None], loop_w=torch.tensor([5.0]))


def test_posegraph_on_card_is_deterministic(cuda_device):
    pg = _square_graph()
    pg_gpu = posegraph.PoseGraph(*(t.to(cuda_device) for t in pg))
    # the engine's solve (8 x 32): two runs on the card are identical
    a = posegraph.optimize(pg_gpu, gn_iters=8, cg_iters=32)
    b = posegraph.optimize(pg_gpu, gn_iters=8, cg_iters=32)
    assert a.poses.device == cuda_device
    assert torch.equal(a.poses, b.poses)
    assert torch.equal(a.final_error, b.final_error)
    # against the CPU where CG converges: with 32 CG steps it stops short
    # on this 20-node loop and the poses follow the last bits of its dot
    # products (float32 and float64 differ by 3.6e-3 there, by 6e-6 at
    # 15 x 60 on the CPU)
    a = posegraph.optimize(pg_gpu, gn_iters=15, cg_iters=60)
    cpu = posegraph.optimize(pg, gn_iters=15, cg_iters=60)
    assert float((a.poses.cpu() - cpu.poses).abs().max()) < 1e-4


def _erasor_scene(rng, with_car):
    """tests/test_erasor.py's ground disc, wall and optional car box."""
    n_g = 8000
    r = np.sqrt(rng.uniform(4.0, 40.0 ** 2, n_g))
    th = rng.uniform(0, 2 * np.pi, n_g)
    parts = [np.stack([r * np.cos(th), r * np.sin(th),
                       rng.normal(scale=0.02, size=n_g) - 1.7], 1),
             np.stack([rng.uniform(-15, 15, 2000),
                       np.full(2000, 20.0)
                       + rng.normal(scale=0.02, size=2000),
                       rng.uniform(-1.7, 5, 2000)], 1)]
    if with_car:
        parts.append(np.stack([rng.uniform(8, 12.2, 1200),
                               rng.uniform(-0.9, 0.9, 1200),
                               rng.uniform(-1.7, -0.2, 1200)], 1))
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("car_left", [True, False],
                         ids=["departed-car", "static"])
def test_clean_map_on_card_matches_cpu(cuda_device, car_left):
    rng = np.random.default_rng(0)
    map_pts = _erasor_scene(rng, with_car=True)
    scan_pts = _erasor_scene(rng, with_car=not car_left)
    cfg = erasor.ErasorConfig(max_range=45.0, max_pts_per_bin=256)

    def run(device):
        t = [torch.from_numpy(a).to(device) for a in (
            map_pts, np.ones(len(map_pts), bool), scan_pts,
            np.ones(len(scan_pts), bool), np.zeros(3, np.float32))]
        return erasor.clean_map(*t, cfg)

    a, b, cpu = run(cuda_device), run(cuda_device), run("cpu")
    assert a.dynamic.device == cuda_device
    assert torch.equal(a.dynamic, b.dynamic)
    assert torch.equal(a.dynamic.cpu(), cpu.dynamic)
    assert torch.equal(a.candidate_bins.cpu(), cpu.candidate_bins)
    assert int(a.bin_overflow) == int(cpu.bin_overflow)
    if car_left:
        assert int(a.dynamic.sum()) > 0


def test_engine_window_on_card_matches_cpu(cuda_device):
    """The first window of tests/test_torch_engine.py's run: card twice,
    then the CPU."""
    cfg = config.semantickitti()
    cfg = cfg.replace(
        grid=dataclasses.replace(cfg.grid, sector_res=2.4, azimuth_res=4.0),
        shapes=dataclasses.replace(cfg.shapes, max_points=8192,
                                   max_clusters=128, max_track_points=2048),
        gicp=dataclasses.replace(cfg.gicp, xy_extent=48.0))
    ec = engine.EngineConfig(window=4, max_keyframes=16, submap_points=1024,
                             local_map_kf=2, kf_dist=6.0, kf_rot=0.5,
                             loop_min_gap=4)
    spec = synthetic.SceneSpec(
        trajectory="loop", loop_frames=24, loop_radius=18.0,
        ground_pts=6000, building_pts=800, tree_pts=200, car_pts=250,
        n_moving_cars=2)
    win = synthetic.render_window(synthetic.make_scene(spec), 4, 8192)

    def run(device):
        eng = engine.SlamEngine(cfg, ec, device=device)
        for f in range(4):
            out = eng.feed(win["xyz"][f], win["intensity"][f],
                           win["valid"][f])
        assert out is not None and eng.state.poses.device.type == \
            torch.device(device).type
        return out, eng.state

    before = cl.cluster_labels.launches
    (a, sa), (b, sb), (c, sc) = run(cuda_device), run(cuda_device), run("cpu")
    assert cl.cluster_labels.launches == before + 8
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for name in ("is_kf", "kf_slot", "n_dynamic"):
        np.testing.assert_array_equal(getattr(a, name), getattr(c, name))
    assert float(np.abs(a.poses - c.poses).max()) < 5e-4
    assert int((a.removed != c.removed).sum()) <= win["valid"].sum() // 1000
    for name in ("n", "frames", "submap_fill", "track_counter",
                 "odo_fallbacks"):
        assert torch.equal(getattr(sa, name).cpu(), getattr(sc, name)), name


@pytest.mark.parametrize("leaf", [0.08, 0.5])
def test_voxel_downsample_on_card_matches_cpu(cuda_device, leaf):
    """Points on leaf edges land in the same leaf on the card as on the
    CPU (a division by a Python scalar on the card would not)."""
    rng = np.random.default_rng(11)
    edges = (rng.integers(-2000, 2000, size=(20000, 3)) * leaf)
    xyz = np.concatenate([rng.uniform(-60, 60, size=(20000, 3)), edges]
                         ).astype(np.float32)
    valid = rng.random(len(xyz)) < 0.9
    want = quantize.voxel_downsample(torch.from_numpy(xyz),
                                     torch.from_numpy(valid), leaf)
    got = quantize.voxel_downsample(torch.from_numpy(xyz).to(cuda_device),
                                    torch.from_numpy(valid).to(cuda_device),
                                    leaf)
    assert torch.equal(got.cpu(), want)


def _leaf_scan(rng, n):
    """n float32 points, a third on 0.08 m leaf edges or a float either
    side, the rest spread and repeated within their leaves, with far,
    infinite and NaN points; reflectance in [0, 1]."""
    edge = rng.integers(-300, 300, size=(n // 3, 3)).astype(
        np.float32) * np.float32(0.08)
    edge = np.where(rng.random(edge.shape) < 0.3,
                    np.nextafter(edge, np.float32(-np.inf)), edge)
    free = rng.uniform(-24, 24, size=(n - len(edge), 3)).astype(np.float32)
    odd = np.array([[1e6, -1e6, 0], [np.inf, 0, 0], [-np.inf, 1, 1],
                    [np.nan, 0, 0], [0, 0, np.nan], [1e30, 0, 0],
                    [-1e30, 0, 0]], np.float32)
    xyz = np.concatenate([edge, free, free[: n // 4] + np.float32(0.01),
                          odd])
    xyz = xyz[rng.permutation(len(xyz))]
    refl = rng.uniform(0, 1, size=(len(xyz), 1)).astype(np.float32)
    return np.concatenate([xyz, refl], 1)


def test_scan_stream_down_samples_on_card_as_the_host(cuda_device,
                                                      tmp_path):
    """The third scan's kept points overflow the 4,096-point padding."""
    cfg = config.tiny_test()
    N = cfg.shapes.max_points
    rng = np.random.default_rng(17)
    d = tmp_path / "velodyne"
    d.mkdir()
    files = [d / f"{k * cfg.skip:06d}.bin" for k in range(3)]
    for k, (f, n) in enumerate(zip(files, (900, 3000, 9000))):
        _leaf_scan(rng, n).tofile(f)
        for j in range(1, cfg.skip):     # the files the stream skips
            os.link(f, d / f"{k * cfg.skip + j:06d}.bin")
    with np.errstate(invalid="ignore"):
        pts = np.concatenate([np.fromfile(f, np.float32).reshape(-1, 4)
                              for f in files])
        want = np.floor(pts[:, :3] / np.float32(0.08)).astype(np.int64)
    got = quantize.leaf_index(torch.from_numpy(pts[:, :3]).to(cuda_device),
                              0.08)
    np.testing.assert_array_equal(got.cpu().numpy(), want)

    host = cli._pad_on_host(N)
    with np.errstate(invalid="ignore"):
        want = [host(xyz, inten) for xyz, inten, _ in prefetch.ScanPrefetcher(
            files, None, max_points=4 * N, max_intensity=cfg.max_intensity)]
    assert want[-1][2].all()                      # the cut at N is tested
    with timing.recording() as rec:
        scans, n = cli.stream_scans(d, cfg)
        got = list(scans)
    assert n == len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    assert rec.counts["scan.leaf_card"] == n
    assert "scan.leaf_host" not in rec.counts
    assert rec.syncs.by_span["downsample"] == n


@pytest.mark.parametrize("seed", range(4))
def test_refine_by_intensity_on_card_reaches_kernel_1(cuda_device, seed):
    """refine_by_intensity at 24 rounds from kernel 2's labels equals
    kernel 1 on random tiny_test() grids."""
    cfg = config.tiny_test()
    cfg = dataclasses.replace(cfg, seg=dataclasses.replace(cfg.seg,
                                                           iteration=24))
    rng = np.random.default_rng(seed)
    occ = torch.from_numpy(rng.random(cfg.grid.shape) < 0.15).to(cuda_device)
    mean, var = (torch.from_numpy(rng.uniform(0, hi, cfg.grid.bin_num)
                                  .astype(np.float32)).to(cuda_device)
                 for hi in (6.0, 2.0))
    sc = cfg.seg
    grid = VoxelGrid(count=occ.reshape(-1).int(), intensity_mean=mean,
                     intensity_var=var)
    want = cl.cluster_labels(occ, mean, var, sc.search_c, sc.intensity_cov,
                             sc.intensity_diff, sc.far_range_frac)
    got = segmentation.refine_by_intensity(cc.cc_labels(occ), grid, cfg)
    assert torch.equal(got, want)


def test_profiler_split_reads_segment_reduce(cuda_device):
    out = profile_stages.run(["segrest"], config.tiny_test(), cuda_device,
                             reps=2, split=True)
    assert out["segment_frame FULL segment_reduce"] > 0


# ------------------------------------------------------------ segment sums

@contextlib.contextmanager
def _no_host_sync():
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _kernel_sum(x, order, seg_sorted, num):
    """The card path of `segment_sum_planned`, under sync debug mode
    "error", checking that it launched the kernel once."""
    before = segment_ops.segment_sum.launches
    with _no_host_sync():
        got = segment_ops.segment_sum_planned(x, order, seg_sorted, num)
    assert segment_ops.segment_sum.launches == before + 1
    return got


@pytest.fixture(scope="module")
def main_path_segment_sums():
    """{name: (x, order, sorted ids, num)} of the planned sums that the
    main path makes on a rendered full-width frame: patchwork's three
    plane fits and z histogram, the curved-voxel moments, and the GICP
    voxel map at 262,144 (two scans), 131,072 and 12,288 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return kernel_times.main_path_segment_sums(torch.device("cuda", 0))


MAIN_PATH_SUMS = ["plane-fit-0", "plane-fit-1", "plane-fit-2", "z-histogram",
                  "voxel-moments", "gicp-262144", "gicp-131072",
                  "gicp-12288"]


@pytest.mark.parametrize("name", MAIN_PATH_SUMS)
def test_segment_sum_kernel_equals_segment_reduce_on_main_path(
        main_path_segment_sums, name):
    """The kernel against torch.segment_reduce on the card (the path it
    replaced), bit for bit, at the main path's operands; the dropped
    bucket holds tens of thousands of rows."""
    x, order, seg_sorted, num = main_path_segment_sums[name]
    want = segment_ops.segment_sum_reference(x, order, seg_sorted, num)
    got = _kernel_sum(x, order, seg_sorted, num)
    dropped = int((seg_sorted == num).sum())
    print(f"{name}: {tuple(x.shape)} -> {num}, {dropped} rows dropped")
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)
    assert bool(got.abs().sum() > 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [1, 10, 12, 40, 256])
@pytest.mark.parametrize("case", ["heavy-drop", "long-runs", "all-dropped",
                                  "ragged"])
def test_segment_sum_kernel_equals_segment_reduce_on_random_cases(
        cuda_device, case, K, dtype):
    """Random operands with most rows in the dropped bucket, runs of
    thousands of rows, every row dropped, and a row count that is no
    multiple of 32: the kernel equals torch.segment_reduce on the card
    ([M, K], a thread per (segment, column) summing in row order) bit for
    bit."""
    g = torch.Generator(device="cpu").manual_seed(K * 10 + len(case))
    M, num = {"heavy-drop": (50_000, 5_000), "long-runs": (40_000, 9),
              "all-dropped": (3_000, 100), "ragged": (1_001, 77)}[case]
    ids = torch.randint(-2, num + 2, (M,), generator=g)
    if case == "heavy-drop":
        ids = torch.where(torch.rand(M, generator=g) < 0.7, num, ids)
    elif case == "all-dropped":
        ids = torch.where(ids % 2 == 0, -1, num + 3)
    x = torch.randn(M, K, generator=g, dtype=dtype)
    x[torch.rand(M, generator=g) < 0.1] = -0.0
    x, ids = x.to(cuda_device), ids.to(cuda_device)
    order, seg_sorted = segment_ops.segment_plan(ids, num)
    want = segment_ops.segment_sum_reference(x, order, seg_sorted, num)
    got = _kernel_sum(x, order, seg_sorted, num)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


def test_segment_sum_kernel_sums_a_vector_in_row_order(cuda_device):
    """An [M] operand: the card sums each segment in row order, as the CPU
    does (torch.segment_reduce reduced [M] by a tree on the card)."""
    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn(20_000, generator=g) * 1e4
    ids = torch.randint(-1, 30, (20_000,), generator=g)
    want = segment_ops.segment_sum(x, ids, 30)
    order, seg_sorted = segment_ops.segment_plan(ids.to(cuda_device), 30)
    got = _kernel_sum(x.to(cuda_device), order, seg_sorted, 30)
    assert got.shape == (30,) and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("shape", [(0,), (0, 3), (0, 256)])
def test_segment_sum_kernel_of_no_rows_is_zeros(cuda_device, shape):
    """No row: zeros of [num, ...], as on the CPU, no launch and no count."""
    x = torch.zeros(shape, device=cuda_device)
    ids = torch.zeros(0, dtype=torch.long, device=cuda_device)
    before = segment_ops.segment_sum.launches
    with timing.recording() as rec, _no_host_sync():
        got = segment_ops.segment_sum(x, ids, 5)
    assert segment_ops.segment_sum.launches == before
    assert rec.counts == {}
    assert got.shape == (5,) + shape[1:] and not bool(got.any())


def test_segment_sum_counts_the_card_path(cuda_device):
    x = torch.ones(100, 3, device=cuda_device)
    ids = torch.arange(100, device=cuda_device) % 7
    with timing.recording() as rec:
        s = segment_ops.segment_sum(x, ids, 5)
    assert rec.counts == {"segment_sum.card": 1}
    assert torch.equal(s[:, 0].cpu(), torch.tensor([15.0, 15, 14, 14, 14]))
    with pytest.raises(TypeError):
        segment_ops.segment_sum(x.half(), ids, 5)


# ---------------------------------------------------------------- bin edges

def _edge_inputs(xyz, device, ego=(0.0, 0.0, 0.0)):
    """(CPU (xyz, valid), card (xyz, valid)) of the points of `xyz` whose
    angles round alike on both devices (edges.same_angles)."""
    keep = edges.same_angles(xyz, device, ego)
    print(f"{int(keep.sum())} of {len(keep)} edge points kept "
          f"({int((~keep).sum())} with another atan2 on the card)")
    assert keep.sum() > 0.4 * len(keep)
    x = torch.from_numpy(xyz[keep])
    v = torch.ones(len(x), dtype=torch.bool)
    return (x, v), (x.to(device), v.to(device))


def _same(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("axis", ["sector", "range", "azimuth"])
def test_quantize_on_bin_edges(cuda_device, axis):
    grid = config.semantickitti().grid
    cpu, card = _edge_inputs(edges.quantize_cloud(grid, axis), cuda_device)
    if axis == "sector":
        # the cloud holds points that a product with the reciprocal puts
        # into the other sector on this card
        v = geometry.polar_angle_deg(card[0]) - grid.min_angle
        exact = torch.full((), grid.sector_res, device=cuda_device)
        assert bool((torch.ceil(v / grid.sector_res)
                     != torch.ceil(v / exact)).any())
    _same(quantize.quantize(*card, grid), quantize.quantize(*cpu, grid))


@pytest.mark.parametrize("axis", ["ring", "sector"])
def test_patchwork_patch_ids_on_bin_edges(cuda_device, axis):
    pw = config.semantickitti().patchwork
    cpu, card = _edge_inputs(edges.patchwork_cloud(pw, axis), cuda_device)
    want = patchwork._patch_id(*cpu, pw)
    assert bool((want < pw.num_patches).all())
    assert torch.equal(patchwork._patch_id(*card, pw).cpu(), want)


def test_patchwork_z_histogram_on_bin_edges(cuda_device):
    pw = config.semantickitti().patchwork
    z_lo = -1.8 * pw.sensor_height
    z = edges.around(z_lo + 8.0 / patchwork._NB
                     * np.arange(1, patchwork._NB))
    xyz = edges.polar([20.0], [0.7]).repeat(len(z), 0)
    xyz[:, 2] = z
    x = torch.from_numpy(xyz)
    pid = patchwork._patch_id(x, torch.ones(len(x), dtype=torch.bool), pw)
    want = patchwork._z_histogram(x, pid, pw)
    got = patchwork._z_histogram(x.to(cuda_device), pid.to(cuda_device), pw)
    _same(got, want)


@pytest.mark.parametrize("axis", ["ring", "sector"])
def test_scan_context_on_bin_edges(cuda_device, axis):
    dc = scan_context.DescriptorConfig()
    cpu, card = _edge_inputs(edges.ring_sector_cloud(
        dc.min_range, dc.max_range, dc.rings, dc.sectors, axis), cuda_device)
    z = torch.arange(len(cpu[0]), dtype=torch.float32) * 1e-3
    cpu[0][:, 2], card[0][:, 2] = z, z.to(cuda_device)
    assert torch.equal(scan_context.cell_index(*card, dc).cpu(),
                       scan_context.cell_index(*cpu, dc))
    assert torch.equal(scan_context.descriptor(*card, dc).cpu(),
                       scan_context.descriptor(*cpu, dc))


@pytest.mark.parametrize("axis", ["ring", "sector"])
def test_erasor_on_bin_edges(cuda_device, axis):
    """The bins of points on ERASOR's edges around an ego position, and
    clean_map on a map where those points stand as an object above a
    noisy ground disc that the scan sees without them."""
    ec = erasor.ErasorConfig()
    ego = (3.0, -2.0, 0.0)
    cpu, card = _edge_inputs(edges.ring_sector_cloud(
        ec.min_range, ec.max_range, ec.num_rings, ec.num_sectors, axis, ego),
        cuda_device, ego)
    ego_c = torch.tensor(ego)
    _same(erasor._bin_index(*card, ego_c.to(cuda_device), ec),
          erasor._bin_index(*cpu, ego_c, ec))

    rng = np.random.default_rng(2)

    def ground(n=20000):
        r = np.sqrt(rng.uniform(ec.min_range ** 2, ec.max_range ** 2, n))
        th = rng.uniform(0, 2 * np.pi, n)
        return torch.from_numpy(np.stack([
            r * np.cos(th) + ego[0], r * np.sin(th) + ego[1],
            rng.normal(scale=0.02, size=n) - 1.7], 1).astype(np.float32))

    obj = cpu[0].clone()
    obj[:, 2] = torch.arange(len(obj), dtype=torch.float32) % 7 * 0.25 - 1.2
    map_xyz, scan_xyz = torch.cat([ground(), obj]), ground()
    mv, sv = (torch.ones(len(t), dtype=torch.bool) for t in (map_xyz,
                                                              scan_xyz))
    want = erasor.clean_map(map_xyz, mv, scan_xyz, sv, ego_c, ec)
    got = erasor.clean_map(*(t.to(cuda_device) for t in (map_xyz, mv,
                                                          scan_xyz, sv,
                                                          ego_c)), ec)
    assert bool(want.dynamic[-len(obj):].any())
    _same(got, want)


def test_gicp_voxels_on_bin_edges(cuda_device):
    gc = config.semantickitti().gicp
    x = torch.from_numpy(edges.voxel_cloud(gc))
    v = torch.ones(len(x), dtype=torch.bool)
    _same(gicp.voxel_index(x.to(cuda_device), v.to(cuda_device), gc),
          gicp.voxel_index(x, v, gc))


# ------------------------------------------ the evaluation subcommands


def _cli_lines(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main([str(a) for a in argv]) == 0
    return buf.getvalue().splitlines()


def _card_and_cpu(argv):
    """The lines of a subcommand with the default device (the card) and
    with --device cpu; `{dev}` in an argument becomes the device's name."""
    out = []
    for tag, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        a = [str(x).replace("{dev}", tag) for x in argv]
        out.append(_cli_lines(a[:1] + extra + a[1:]))
    return out


def _labelled_frame(tmp_path):
    """A labelled GT cloud (static 40, moving car 252) and estimated static
    and dynamic clouds: some points kept, some moved by 3 cm, some lost."""
    rng = np.random.default_rng(3)
    gt = (rng.normal(size=(1500, 4)) * 10).astype(np.float32)
    gt[:, 3] = 40
    gt[1200:, 3] = 252
    moved = gt.copy()
    moved[:, :3] += rng.normal(scale=0.03, size=(1500, 3))
    paths = [tmp_path / n for n in ("gt.pcd", "s.pcd", "d.pcd")]
    for path, pts in zip(paths, (gt, np.concatenate([moved[:1000],
                                                     moved[1200:1260]]),
                                 np.concatenate([moved[1000:1100],
                                                 moved[1260:]]))):
        io_kitti.write_pcd_xyzi(path, pts)
    return gt, paths


def test_float32_matmul_is_the_default():
    """`cli evaluate` computes nearest distances with a matmul: PyTorch's
    default keeps its products in float32 (no TF32)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_cli_evaluate_on_card_matches_cpu(cuda_device, tmp_path):
    gt, (g, s, _) = _labelled_frame(tmp_path)
    card, cpu = _card_and_cpu(["evaluate", "--gt", g, "--est", s])
    assert card == cpu and card[0].startswith("PR=")
    d = artifact.nn_distances(gt[:, :3], io_kitti.read_pcd_xyzi(s)[:, :3],
                              device=cuda_device)
    assert d.device.type == "cuda"


def test_cli_evaluate_map_on_card_matches_cpu(cuda_device, tmp_path):
    _, (g, s, d) = _labelled_frame(tmp_path)
    out = tmp_path / "eval_{dev}.pcd"
    card, cpu = _card_and_cpu(["evaluate-map", "--gt", g, "--static", s,
                               "--dynamic", d, "--out", out])
    assert card[0].split(" -> ")[0] == cpu[0].split(" -> ")[0]
    assert "TP=0 " not in card[0]
    a, b = (io_kitti.read_pcd_xyzi(str(out).replace("{dev}", t))
            for t in ("card", "cpu"))
    np.testing.assert_array_equal(a, b)


def test_cli_erasor_on_card_matches_cpu(cuda_device, tmp_path):
    rng = np.random.default_rng(5)

    def cloud(with_car):
        r = np.sqrt(rng.uniform(4.0, 40.0 ** 2, 4000))
        th = rng.uniform(0, 2 * np.pi, 4000)
        parts = [np.stack([r * np.cos(th), r * np.sin(th),
                           rng.normal(scale=0.02, size=4000) - 1.7], 1)]
        if with_car:
            parts.append(np.stack([rng.uniform(8, 12.2, 600),
                                   rng.uniform(-0.9, 0.9, 600),
                                   rng.uniform(-1.7, -0.2, 600)], 1))
        xyz = np.concatenate(parts).astype(np.float32)
        return np.concatenate([xyz, np.zeros((len(xyz), 1), np.float32)], 1)

    io_kitti.write_pcd_xyzi(tmp_path / "map.pcd", cloud(True))
    io_kitti.write_pcd_xyzi(tmp_path / "scan.pcd", cloud(False))
    card, cpu = _card_and_cpu([
        "erasor", "--map", tmp_path / "map.pcd", "--scan",
        tmp_path / "scan.pcd", "--ego", json.dumps([0.0, 0.0, 0.0]),
        "--out-static", tmp_path / "s_{dev}.pcd",
        "--out-dynamic", tmp_path / "d_{dev}.pcd"])
    assert card == cpu and " dynamic 0 " not in card[0]
    for part in ("s", "d"):
        np.testing.assert_array_equal(
            io_kitti.read_pcd_xyzi(tmp_path / f"{part}_card.pcd"),
            io_kitti.read_pcd_xyzi(tmp_path / f"{part}_cpu.pcd"))
