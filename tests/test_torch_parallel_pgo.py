"""The port's distributed pose-graph solves against the JAX package's, on
the CPU: the port's ranks are spawned processes in a gloo group
(tests/torch_mp_worker.py, a file store under tmp_path, each wait bounded),
worlds of 2 and 4 ranks; the JAX references run in this process on CPU
meshes of the same size. Graphs: tests/test_posegraph.py's noisy square
(20 nodes, one loop edge), tests/mp_worker.py:93-117's 32-node loop (two
loop edges) and a 16-node chain of the same helix (two loop edges, the
size of tests/test_schur_pgo.py's).

optimize_distributed runs at converged settings: where the solve stops
short, every new reduction order shows (ROADMAP.md section 3). The square
converges at 12 Gauss-Newton steps of 60 CG steps (tests/
test_distributed_pgo.py's); the 32-node loop does not (float32 and float64
solves differ by 2.8e-2 there) and runs 15 x 100 (1.4e-5 apart).

Tolerances:
  * partition_graph: none (separators, edge blocks, padded graph);
  * optimize_distributed: poses within 1e-4 of the JAX run on the same
    number of ranks and of the port's single-process posegraph.optimize
    (float32 sums of the edge shards added in another order; the
    single-process solve also re-orthonormalizes its rotations, which the
    distributed one does not, as in the JAX package; 6.7e-6 measured
    against the JAX run); final error within 1e-4 relative;
  * optimize_schur: finite, error below 0.25 of the start (mp_worker.py),
    poses within 1e-4 of the JAX run on the same number of ranks (float32
    LU solves in LAPACK's and XLA's orders; 2.4e-6 measured), and within
    2e-4 of the port's posegraph.optimize at 15 x 100 (another solver that
    reaches the same optimum: 7.8e-5 measured).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_using_scv_od_tpu.models import posegraph as jpgo
from dr_using_scv_od_tpu.ops import geometry as jgeometry
from dr_using_scv_od_tpu.parallel import distributed_pgo as jdist
from dr_using_scv_od_tpu.parallel import mesh as jmesh
from dr_using_scv_od_tpu.parallel import schur_pgo as jschur
from dr_using_scv_od_tpu_torch.models import posegraph
from dr_using_scv_od_tpu_torch.parallel import distributed_pgo, schur_pgo

import torch_mp_worker
from test_posegraph import _noisy_square

SETTINGS = {"square": (12, 60), "loop": (15, 100)}   # GN x CG steps
WORLD_TIMEOUT = 240.0
FIELDS = ("poses", "edge_i", "edge_j", "edge_T", "edge_w")
POSE_ATOL = 1e-4
SOLVER_ATOL = 2e-4    # Schur against the converged CG solve


def _loop_graph(F=32, seed=7, loops=((0, 31), (3, 27))):
    """A 1.5-turn helix of F poses, noisy odometry (0.02 per twist entry),
    exact loop edges (tests/mp_worker.py:93-117 at F=32; with F=16 and two
    random loops tests/test_schur_pgo.py's chain)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1.5 * np.pi, F)
    gt = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    yaw = t + np.pi / 2
    gt[:, 0, 0] = np.cos(yaw)
    gt[:, 0, 1] = -np.sin(yaw)
    gt[:, 1, 0] = np.sin(yaw)
    gt[:, 1, 1] = np.cos(yaw)
    gt[:, 0, 3] = 5 * np.cos(t)
    gt[:, 1, 3] = 5 * np.sin(t)
    gt = jnp.asarray(gt)
    rel = jnp.einsum('fij,fjk->fik', jgeometry.inverse_se3(gt[:-1]), gt[1:])
    noise = jnp.asarray(rng.normal(0, 0.02, (F - 1, 6)).astype(np.float32))
    rel = jnp.einsum('fij,fjk->fik', rel,
                     jnp.stack([jgeometry.exp_se3(n) for n in noise]))
    li = jnp.asarray([a for a, _ in loops], jnp.int32)
    lj = jnp.asarray([b for _, b in loops], jnp.int32)
    lT = jnp.einsum('fij,fjk->fik', jgeometry.inverse_se3(gt[li]), gt[lj])
    return jpgo.make_odometry_graph(jpgo.odometry_chain(rel), rel, li, lj,
                                    lT, jnp.ones((len(loops),)))


def _square_graph():
    gt, rels = _noisy_square(np.random.default_rng(0))
    F = gt.shape[0]
    T_loop = np.linalg.inv(gt[F - 1]) @ gt[0]
    return jpgo.make_odometry_graph(
        jpgo.odometry_chain(jnp.asarray(rels)), jnp.asarray(rels),
        loop_i=jnp.asarray([F - 1]), loop_j=jnp.asarray([0]),
        loop_T=jnp.asarray(T_loop[None].astype(np.float32)),
        loop_w=jnp.asarray([5.0]))


def _np(pg):
    return {k: np.asarray(getattr(pg, k)) for k in FIELDS}


def _torch(arrays):
    return posegraph.PoseGraph(*(torch.from_numpy(arrays[k].copy())
                                 for k in FIELDS))


@pytest.fixture(scope="module")
def graphs():
    return {"square": _np(_square_graph()), "loop": _np(_loop_graph()),
            "chain": _np(_loop_graph(16, loops=((2, 14), (5, 11))))}


@pytest.fixture(scope="module")
def ranks(graphs, tmp_path_factory):
    inputs = {f"{name}_{k}": v for name, g in graphs.items()
              for k, v in g.items()}
    for name, (gn, cg) in SETTINGS.items():
        inputs.update({f"{name}_gn": gn, f"{name}_cg": cg})
    return {w: torch_mp_worker.spawn_world(
        w, tmp_path_factory.mktemp(f"world{w}"), ["pgo", "schur"], inputs,
        WORLD_TIMEOUT) for w in (2, 4)}


@pytest.fixture(scope="module")
def jax_runs(graphs):
    out = {}
    for n in (2, 4):
        mesh = jmesh.make_mesh(n)
        for name in ("square", "loop"):
            pg = jpgo.PoseGraph(**{k: jnp.asarray(v)
                                   for k, v in graphs[name].items()})
            gn, cg = SETTINGS[name]
            out["cg", name, n] = [np.asarray(a) for a in
                                  jdist.optimize_distributed(
                                      pg, mesh, gn_iters=gn, cg_iters=cg)]
        for name in ("chain", "loop"):
            pg = jpgo.PoseGraph(**{k: jnp.asarray(v)
                                   for k, v in graphs[name].items()})
            out["schur", name, n] = [np.asarray(a) for a in
                                     jschur.optimize_schur(pg, mesh,
                                                           gn_iters=8)]
    return out


def _replicated(results, keys):
    for r, res in enumerate(results[1:], 1):
        for k in keys:
            np.testing.assert_array_equal(res[k], results[0][k],
                                          err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["square", "loop"])
def test_optimize_distributed_matches(ranks, jax_runs, graphs, world, name):
    got = ranks[world]
    _replicated(got, (f"cg_{name}_poses", f"cg_{name}_err"))
    poses, err = got[0][f"cg_{name}_poses"], got[0][f"cg_{name}_err"]
    want_poses, want_err = jax_runs["cg", name, world]
    np.testing.assert_allclose(poses, want_poses, atol=POSE_ATOL)
    np.testing.assert_allclose(err, want_err, rtol=1e-4)
    gn, cg = SETTINGS[name]
    single = posegraph.optimize(_torch(graphs[name]), gn_iters=gn,
                                cg_iters=cg)
    np.testing.assert_allclose(poses, single.poses.numpy(), atol=POSE_ATOL)
    np.testing.assert_allclose(err, float(single.final_error), rtol=1e-4)
    err0 = float(torch.sum(posegraph.residuals(_torch(graphs[name])) ** 2))
    assert float(err) < 0.25 * err0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["chain", "loop"])
def test_optimize_schur_matches(ranks, jax_runs, graphs, world, name):
    got = ranks[world]
    _replicated(got, (f"schur_{name}_poses", f"schur_{name}_err"))
    poses, err = got[0][f"schur_{name}_poses"], got[0][f"schur_{name}_err"]
    err0 = float(torch.sum(posegraph.residuals(_torch(graphs[name])) ** 2))
    assert np.isfinite(poses).all() and np.isfinite(err)
    assert float(err) < 0.25 * err0, (err0, float(err))
    want_poses, _ = jax_runs["schur", name, world]
    np.testing.assert_allclose(poses, want_poses, atol=POSE_ATOL)
    single = posegraph.optimize(_torch(graphs[name]), gn_iters=15,
                                cg_iters=100)
    np.testing.assert_allclose(poses, single.poses.numpy(), atol=SOLVER_ATOL)
    # the gauge: keyframe 0 stays where it started
    np.testing.assert_allclose(poses[0], graphs[name]["poses"][0],
                               atol=1e-5)


@pytest.mark.parametrize("n_blocks", [2, 4, 8])
@pytest.mark.parametrize("name", ["chain", "loop"])
def test_partition_graph_identical(graphs, name, n_blocks):
    g = graphs[name]
    padded, part = schur_pgo.partition_graph(_torch(g), n_blocks)
    jpadded, jpart = jschur.partition_graph(
        jpgo.PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()}),
        n_blocks)
    np.testing.assert_array_equal(part.sep_ids, jpart.sep_ids)
    assert part.sep_ids.dtype == jpart.sep_ids.dtype
    np.testing.assert_array_equal(part.edge_block, jpart.edge_block)
    assert (part.n_blocks, part.block_size) == (jpart.n_blocks,
                                                jpart.block_size)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(padded, k).numpy(),
                                      np.asarray(getattr(jpadded, k)),
                                      err_msg=k)


def test_partition_graph_indivisible_raises(graphs):
    g = _torch(graphs["chain"])
    g = g._replace(poses=g.poses[:10])
    with pytest.raises(ValueError):
        schur_pgo.partition_graph(g, 4)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_pad_and_sort_edges_equal(graphs, n):
    g = graphs["loop"]
    got = distributed_pgo.pad_and_sort_edges(_torch(g), n)
    want = jdist.pad_and_sort_edges(
        jpgo.PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()}), n)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
