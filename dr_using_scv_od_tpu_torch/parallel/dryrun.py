"""The multi-rank dry run (counterpart of
`__graft_entry__.dryrun_multichip`, __graft_entry__.py:47-166): every
strategy of the parallel layer once on tiny shapes, with the JAX function's
scene, steps and asserts.

  * dp: frame-block data parallelism with the ring halo for the tracking
    boundary pairs;
  * tp: point-sharded voxel statistics with an all-reduced grid;
  * pp: the GPipe-style stage pipeline (ground -> segment -> recognize);
  * the distributed pose-graph solves, CG and Schur;
  * two windows of the SLAM engine. Eager PyTorch has no sharded input, so
    where the JAX function feeds the engine scans sharded over the mesh,
    each rank here runs a SlamEngine on its own device from its own copy
    of the scans.

Run on every rank after `mesh.init_group`; rank 0 prints the summary.
"""

from __future__ import annotations

import torch

from .. import config, interop
from ..models import engine as engine_mod
from ..models import posegraph
from ..ops import geometry
from ..utils import synthetic
from . import (distributed_pgo, mesh, pipeline_parallel, schur_pgo,
               sharded_pipeline, tensor_parallel)


def dryrun_multichip(n_devices: int) -> None:
    """The full multi-rank step on the `n_devices` ranks of the world, on
    the device the process group was initialized for."""
    if mesh.world_size() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) on a world of "
                         f"{mesh.world_size()} ranks")
    dev = mesh.group_device()
    cfg = config.tiny_test()
    # ego_speed stays small so the ORBITING movers remain inside the tiny
    # grid for the whole window, and no trees: on the 1 m tiny grid a mover
    # passing a tree canopy merges with it and stops being car-typed - the
    # dry run needs dynamics JUDGED in every block
    spec = synthetic.SceneSpec(ground_pts=1200, building_pts=200,
                               tree_pts=0, car_pts=100, n_buildings=2,
                               n_trees=0, n_parked_cars=1, n_moving_cars=2,
                               extent=14.0, moving_speed=4.0, ego_speed=0.25,
                               mover_path="pingpong")
    scene = synthetic.make_scene(spec)
    frames_per_device = 2
    F = n_devices * frames_per_device
    win = synthetic.render_window(scene, F, cfg.shapes.max_points)
    xyz, intensity, valid, poses = interop.window_from_numpy(win, dev)

    # --- dp + ring-halo tracking
    removed, _, n_dyn = sharded_pipeline.sharded_run_window(
        xyz, intensity, valid, poses, cfg)
    assert tuple(removed.shape) == win["xyz"].shape[:2]
    # the movers stay in-grid for all F frames, so the LAST block's pairs
    # must still see dynamic verdicts - the ring halo carries tracking
    # state through every block, not just the first
    n_dyn_arr = n_dyn.cpu().numpy()
    assert n_dyn_arr[-frames_per_device:-1].sum() > 0 or n_dyn_arr[-1] > 0, (
        f"no dynamic verdicts in the last device block: {n_dyn_arr.tolist()}")

    # --- tp: one scan's voxel stats with points sharded over all ranks
    vg = tensor_parallel.tp_voxel_stats(xyz[0], intensity[0], valid[0],
                                        cfg.grid)
    assert int(vg.count.sum()) > 0

    # --- pp: the stage pipeline on the first min(3, n) ranks
    ppres = pipeline_parallel.pipelined_process_window(
        xyz[:3], intensity[:3], valid[:3], cfg, n_stages=min(3, n_devices))
    assert int(ppres.n_clusters[0]) > 0

    # --- distributed pose graph over the window's odometry chain
    rel = geometry.inverse_se3(poses[:-1]) @ poses[1:]
    pg = posegraph.make_odometry_graph(poses, rel)
    opt_poses, err = distributed_pgo.optimize_distributed(
        pg, gn_iters=2, cg_iters=10)
    # --- Schur-complement variant of the same solve (F = n*2 divides n)
    sposes, serr = schur_pgo.optimize_schur(pg, gn_iters=2)
    assert bool(torch.isfinite(opt_poses).all()
                & torch.isfinite(sposes).all())

    # --- two windows of the SLAM engine, keyframe gating on
    W = max(3, n_devices)
    Fe = 2 * W - 1                      # two windows w/ 1-frame overlap
    ewin = synthetic.render_window(scene, Fe, cfg.shapes.max_points)
    ec = engine_mod.EngineConfig(
        window=W, max_keyframes=16, submap_points=256, local_map_kf=2,
        kf_dist=0.3, loop_min_gap=2, loop_top_k=2,
        desc=engine_mod.scan_context.DescriptorConfig(rings=4, sectors=8,
                                                      max_range=16.0))
    eng = engine_mod.SlamEngine(cfg, ec, device=dev)
    for f in range(Fe):
        out = eng.feed(ewin["xyz"][f], ewin["intensity"][f],
                       ewin["valid"][f])
    st = eng.state
    assert eng.windows == 2
    assert int(st.n) >= 2, "engine dryrun produced < 2 keyframes"
    assert int(st.frames) == Fe
    assert int(st.kf_overflow) == 0
    assert out.removed.shape == (W - 1, cfg.shapes.max_points)

    if mesh.rank() == 0:
        print(f"dryrun_multichip({n_devices}): OK - removed "
              f"{int(removed.sum())} pts across {F} frames, "
              f"verdicts per pair {n_dyn_arr.tolist()}, "
              f"tp-grid occupied {int((vg.count > 0).sum())}, "
              f"pgo err {float(err):.4f}, engine 2 windows -> "
              f"{int(st.n)} keyframes", flush=True)
