"""The three stress scenes of tests/test_hard_scenes.py, run through the
JAX package and the port on the same window, for
tests/test_torch_hard_scenes.py and tests/test_torch_hard_scenes_wall.py.

The JAX run bounds RI3 to cfg.seg.iteration rounds on the CPU, and at the
default 3 it stops short of the fixpoint on the cluttered scene (133
removed points of frame 1 differ). The port's segment_frame runs RI3 to
the fixpoint, so the JAX run here takes 24 rounds (ROADMAP, watch list).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from dr_using_scv_od_tpu import config as jconfig
from dr_using_scv_od_tpu.models import pipeline as jpipeline
from dr_using_scv_od_tpu_torch import config, interop
from dr_using_scv_od_tpu_torch.eval import metrics
from dr_using_scv_od_tpu_torch.models import pipeline
from dr_using_scv_od_tpu_torch.utils import synthetic

RI3_ROUNDS = 24
# name: (SceneSpec fields, F, PR floor, RR floor), tests/test_hard_scenes.py
SCENES = {
    "wall": (dict(wall_parked_cars=2), 4, 99.5, 96.0),
    "stop": (dict(stop_frame=2), 6, 99.0, 88.0),
    "clutter": (dict(wall_parked_cars=2, stop_frame=2, n_trees=12), 6,
                99.0, 82.0),
}


def run_both(name, ri3_rounds=RI3_ROUNDS):
    """(window, JAX outputs as numpy, the port's WindowResult on the CPU,
    the port's RemovalMetrics of the judged frames) of scene `name`, the
    JAX run bounding RI3 to `ri3_rounds` rounds."""
    spec, F, _, _ = SCENES[name]
    cfg = config.semantickitti()
    win = synthetic.render_window(
        synthetic.make_scene(synthetic.SceneSpec(**spec)), F,
        cfg.shapes.max_points)
    jcfg = jconfig.semantickitti()
    jcfg = jcfg.replace(seg=dataclasses.replace(jcfg.seg,
                                                iteration=ri3_rounds))
    j = jpipeline.run_window(
        jnp.asarray(win["xyz"]), jnp.asarray(win["intensity"]),
        jnp.asarray(win["valid"]), jnp.asarray(win["poses"]), jcfg)
    jres = {"removed": j.removed, "point_cluster": j.point_cluster,
            "point_route": j.frames.state.point_route,
            "label_grids": j.label_grids,
            "count": j.frames.state.grid.count}
    jres = {k: np.asarray(v) for k, v in jres.items()}
    res = pipeline.run_window(*interop.window_from_numpy(win, "cpu"), cfg)
    m = metrics.removal_metrics(win["label"][:F - 1],
                                res.removed[:F - 1].numpy(),
                                win["valid"][:F - 1])
    return win, jres, res, m


def assert_matches_jax(win, jres, res):
    """`removed` identical. The named patchwork float case (the port sums
    patch moments in another order than the JAX one-hot matmul, which
    flips the ground verdict of a few borderline points) is bounded as in
    tests/test_torch_pipeline.py: at most 0.05 % of the valid points flip,
    point_cluster differs only at a flipped point, and a label differs only
    in a voxel whose point count differs."""
    np.testing.assert_array_equal(res.removed.numpy(), jres["removed"])
    flipped = res.frames.state.point_route.numpy() != jres["point_route"]
    assert flipped.sum() <= 0.0005 * win["valid"].sum(), int(flipped.sum())
    pc_diff = res.point_cluster.numpy() != jres["point_cluster"]
    assert not (pc_diff & ~flipped).any(), \
        "point_cluster differs where the patchwork verdicts agree"
    count_diff = res.frames.state.grid.count.numpy() != jres["count"]
    lg_diff = res.label_grids.numpy() != jres["label_grids"]
    assert not (lg_diff & ~count_diff).any(), \
        "a label differs in a voxel whose point count is the same"


def assert_floors(name, m):
    """The PR / RR floors of tests/test_hard_scenes.py."""
    _, _, pr, rr = SCENES[name]
    assert m.pr > pr, f"{name}: PR={m.pr}"
    assert m.rr > rr, f"{name}: RR={m.rr}"
