"""Single-frame entry point (counterpart of __graft_entry__.py:15-44; its
multi-device sibling `dryrun_multichip` is parallel/dryrun.py).

    fn, args = entry()          # on the card
    out = fn(*args)             # pipeline.process_frame -> FrameOutput
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import config
from .models import pipeline
from .tools.profile_stages import require_device
from .utils import synthetic


def _example_frame(cfg: config.PipelineConfig):
    """(xyz [N,3] f32, intensity [N] f32, valid [N] bool, pose [4,4] f32):
    frame 0 of a small synthetic scene, padded to cfg.shapes.max_points."""
    spec = synthetic.SceneSpec(ground_pts=4000, building_pts=600,
                               tree_pts=200, car_pts=200, n_buildings=2,
                               n_trees=3, n_parked_cars=2, n_moving_cars=2,
                               extent=20.0)
    xyz, inten, _, pose = synthetic.render_frame(
        synthetic.make_scene(spec), 0)
    N = cfg.shapes.max_points
    X = np.zeros((N, 3), np.float32)
    I = np.zeros((N,), np.float32)
    V = np.zeros((N,), bool)
    n = min(len(xyz), N)
    X[:n], I[:n], V[:n] = xyz[:n], inten[:n], True
    return X, I, V, pose


def entry(device: torch.device | str = "cuda"):
    """(fn, example_args): the full per-frame segmentation + recognition
    pipeline (models/pipeline.py:process_frame) at the semantickitti()
    width, and its arguments on `device` (raises if it is missing)."""
    device = require_device(device)
    cfg = config.semantickitti()
    X, I, V, pose = _example_frame(cfg)
    fn = functools.partial(pipeline.process_frame, cfg=cfg)
    return fn, tuple(torch.tensor(a, device=device) for a in (X, I, V, pose))
