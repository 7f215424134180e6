"""The one traffic generator: a cell's `traffic` object in, the scan
windows it describes out, all drawn from the run's `--seed`.

A traffic object (in `benchmark/workloads/<cell>.json`) holds:
  name      the mix's name, as BENCHMARK.json gives it
  windows   distinct windows to render (the pool a driver cycles through)
  frames    frames in each window
  scene     SceneSpec fields (synthetic.py) of every window's scene; each
            window's seed is drawn from the run's seed and its index
  layout_seed  (optional) the seed of every window's layout (where the
            objects stand, their sizes and intensities, the movers' paths);
            the window's own seed then draws only the points of each scan
and may hold parameters that only its driver reads. Every seed gets the
same sizes (windows x frames x max_points) and the same scene layout
rules; with `layout_seed` it also gets the same place, scanned anew.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

from . import synthetic


def window_seed(seed: int, index: int) -> int:
    """The scene seed of window `index` of a run with `seed`: 31 bits drawn
    from both, so any whole number (negative or past 2**63) is a seed."""
    words = [seed % 2 ** 64, (seed // 2 ** 64) % 2 ** 64, index]
    return int(np.random.SeedSequence(words).generate_state(1)[0] >> 1)


def scene_spec(traffic: Dict[str, Any], seed: int,
               index: int) -> synthetic.SceneSpec:
    fields = {f.name for f in dataclasses.fields(synthetic.SceneSpec)}
    unknown = set(traffic["scene"]) - fields
    if unknown:
        raise KeyError(f"unknown scene parameters {sorted(unknown)}")
    return synthetic.SceneSpec(**traffic["scene"],
                               seed=window_seed(seed, index))


def scene(traffic: Dict[str, Any], seed: int,
          index: int) -> synthetic.Scene:
    """Window `index`'s scene: laid out from `layout_seed` where the
    traffic gives one (else from the window's seed), scanned with the
    window's seed."""
    spec = scene_spec(traffic, seed, index)
    if "layout_seed" not in traffic:
        return synthetic.make_scene(spec)
    placed = synthetic.make_scene(dataclasses.replace(
        spec, seed=traffic["layout_seed"]))
    placed.spec = spec
    return placed


def render(traffic: Dict[str, Any], seed: int,
           max_points: int) -> List[Dict[str, np.ndarray]]:
    """`traffic["windows"]` windows of `traffic["frames"]` frames, each a
    dict of xyz [F,N,3], intensity [F,N], label [F,N], valid [F,N] and
    poses [F,4,4] (synthetic.render_window), padded to `max_points`."""
    return [synthetic.render_window(scene(traffic, seed, k),
                                    traffic["frames"], max_points)
            for k in range(traffic["windows"])]
