"""The tile plan of the tiled union-find behind kernels 1 and 3
(ops/tile_plan.py, csrc/tiled_union_find.cuh), on the CPU.

The plan must cover the grid exactly, fit the card's shared memory, and the
rules by which the tile pass and the seam pass take an edge (mirrored in
PyTorch by `tile_pass_takes` / `seam_pass_takes`) must split the edge list
of `cluster_labels.union_graph_edges` exactly: every edge in one pass and
none in both (the kernels apply the intensity gate after the rule, so the
rules must split every forward pair of occupied voxels in reach).
Tolerance: none, these are integer facts. The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from dr_using_scv_od_tpu_torch import config
from dr_using_scv_od_tpu_torch.ops import cluster_labels as cl
from dr_using_scv_od_tpu_torch.ops import clustering, tile_plan

SHAPES = {"semantickitti": config.semantickitti().grid.shape,
          "tiny_test": config.tiny_test().grid.shape,
          "ragged": (13, 21, 75)}


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("name", ["semantickitti", "tiny_test", "ragged"])
@pytest.mark.parametrize("min_label", [False, True], ids=["k1", "k3"])
def test_plan_covers_grid_and_fits(name, radius, min_label):
    shape = SHAPES[name]
    p = tile_plan.plan(shape, radius, min_label)
    assert p.halo == radius and p.grid == tuple(shape)
    assert max(p.tile_smem, p.seam_smem) <= tile_plan.SMEM_LIMIT
    # every voxel in exactly one tile: the clipped tiles of each axis
    # partition it
    cover = np.zeros(shape, np.int32)
    for ta in range(p.counts[0]):
        for tr in range(p.counts[1]):
            for ts in range(p.counts[2]):
                a0, r0, s0 = ta * p.tile[0], tr * p.tile[1], ts * p.tile[2]
                assert a0 < shape[0] and r0 < shape[1] and s0 < shape[2]
                cover[a0:a0 + p.tile[0], r0:r0 + p.tile[1],
                      s0:s0 + p.tile[2]] += 1
    assert (cover == 1).all()
    assert p.n_tiles == int(np.prod(p.counts))
    assert all(0 < t <= g for t, g in zip(p.tile, shape))
    # one warp a row, one lane a voxel of it
    assert p.tile[0] * p.tile[1] <= p.threads // 32 and p.tile[2] <= 32


def test_plan_shrinks_for_a_large_radius():
    shape = SHAPES["semantickitti"]
    wide = tile_plan.plan(shape, 12)
    assert np.prod(wide.tile) < np.prod(tile_plan.plan(shape, 2).tile)
    assert max(wide.tile_smem, wide.seam_smem) <= tile_plan.SMEM_LIMIT
    assert wide.tile[2] + 2 * 12 <= 64
    with pytest.raises(ValueError):
        tile_plan.plan(shape, 32)


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_decoded_offsets_are_the_forward_offsets(radius):
    assert tile_plan.decoded_offsets(radius) == \
        clustering.forward_offsets(radius)


def _edges(shape, radius, density, seed):
    """union_graph_edges on a random grid whose gate passes on about half
    the shell pairs: (src, offset [E, 3])."""
    rng = np.random.default_rng(seed)
    occ = torch.from_numpy(rng.random(shape) < density)
    mean = torch.from_numpy(rng.uniform(0, 4, occ.numel()).astype(np.float32))
    var = torch.from_numpy(rng.uniform(0, 2, occ.numel()).astype(np.float32))
    _, src, dst = cl.union_graph_edges(occ, mean, var, radius, 1.0, 2.0, 0.6)
    _, R, S = shape
    d = torch.stack([dst // (R * S) - src // (R * S),
                     (dst // S) % R - (src // S) % R, dst % S - src % S], 1)
    return occ, src, d


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("name", ["semantickitti", "tiny_test", "ragged"])
def test_tile_and_seam_passes_partition_the_edges(name, radius):
    shape = SHAPES[name]
    density = 0.01 if name == "semantickitti" else 0.3
    occ, src, d = _edges(shape, radius, density, seed=radius)
    p = tile_plan.plan(shape, radius)
    in_tile = tile_plan.tile_pass_takes(p, src, d)
    in_seam = tile_plan.seam_pass_takes(p, src, d)
    assert src.numel() > 0 and int(in_seam.sum()) > 0
    assert not (in_tile & in_seam).any(), "an edge in both passes"
    assert (in_tile | in_seam).all(), "an edge in neither pass"
    # the same for every forward pair of occupied voxels in reach, gate or
    # no gate
    ids, nbr, ok = clustering.occupied_pairs(
        occ, clustering.forward_offsets(radius))
    offs = torch.tensor(clustering.forward_offsets(radius))
    v = ids[:, None].expand_as(nbr)[ok]
    dv = offs[None].expand(ids.numel(), -1, -1)[ok]
    assert bool((tile_plan.tile_pass_takes(p, v, dv)
                 ^ tile_plan.seam_pass_takes(p, v, dv)).all())


@pytest.mark.parametrize("shape", [(12, 20, 72), (6, 16, 64)])
def test_seam_grids_are_cases_the_plan_splits(shape):
    """The seam cases of chip_smoke.py and the card tests: each has edges
    in the seam pass, and the snakes are one component."""
    cases = tile_plan.seam_grids(shape, 2, 1.0, 2.0)
    assert [c[0] for c in cases] == ["snake-S", "snake-R", "snake-A",
                                     "faces", "dense60", "corners"]
    p = tile_plan.plan(shape, 2)
    for name, occ, mean, var in cases:
        assert occ.shape == shape and occ.flags.c_contiguous
        assert mean.shape == var.shape == (occ.size,)
        occ3 = torch.from_numpy(occ)
        _, src, dst = cl.union_graph_edges(occ3, torch.from_numpy(mean),
                                           torch.from_numpy(var), 2, 1.0,
                                           2.0, 0.6)
        _, R, S = shape
        d = torch.stack([dst // (R * S) - src // (R * S),
                         (dst // S) % R - (src // S) % R,
                         dst % S - src % S], 1)
        assert int(tile_plan.seam_pass_takes(p, src, d).sum()) > 0, name
        if name.startswith("snake"):
            lab = cl.cluster_labels_reference(
                occ3, torch.from_numpy(mean), torch.from_numpy(var), 2, 1.0,
                2.0, 0.6)
            ids = torch.nonzero(occ3.reshape(-1)).squeeze(1)
            assert torch.unique(lab[ids]).numel() == 1, name
