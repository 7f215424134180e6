"""Driver `removal_window`: offline dynamic removal with ground-truth
poses, the use of the reference's own `segdf` (and of the port's `cli
segdf`): a closed loop of back-to-back `pipeline.run_window` calls, each
over one whole window of the traffic's pool, the device synchronised after
each (a batch job that hands each window's verdicts on before the next).

Set-up renders the pool from the seed, uploads it once and runs one window
to warm every shape (every window of the pool has the same shapes).

Timed: `removal_ms_per_frame`, the window's wall time over the frames of
all windows completed in it (the last one ends at or after --seconds).

Traced: one pass over the pool with no profiler and no spans, whose wall
time the idle share is taken against; one pass under the profiler (device
activity only) with host-clock spans that name the idle gaps and put
nothing into the trace; and one pass with synchronised spans around
`patchwork.estimate_ground` ("patchwork") and `tracking.track_window`
("tracking").

`correct`: every window's per-point outputs against the plain reference
(`benchmark/reference`) run on the same pool: the share of valid points
whose dynamic verdict (`removed`), segmentation route (ground, dropped,
clustered, bbox-filtered, out of the grid) or final cluster differs, the
worst window of the run for each.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from benchmark import harness
from benchmark.traffic import generator


class Answer(NamedTuple):
    k: int                     # pool window
    removed: torch.Tensor      # [F, N] bool
    point_cluster: torch.Tensor    # [F, N] int32
    point_route: torch.Tensor      # [F, N] int32


@dataclasses.dataclass
class State:
    device: torch.device
    doc: Dict[str, Any]
    cfg: Any
    pool: List[Tuple[torch.Tensor, ...]]     # (xyz, intensity, valid, poses)

    @property
    def frames(self) -> int:
        return self.pool[0][0].shape[0]


def _upload(win, device) -> Tuple[torch.Tensor, ...]:
    return (torch.as_tensor(win["xyz"], dtype=torch.float32).to(device),
            torch.as_tensor(win["intensity"], dtype=torch.float32).to(device),
            torch.as_tensor(win["valid"], dtype=torch.bool).to(device),
            torch.as_tensor(win["poses"], dtype=torch.float32).to(device))


def _window(pipeline_mod, cfg, inputs, k: int) -> Answer:
    res = pipeline_mod.run_window(*inputs, cfg)
    return Answer(k, res.removed, res.point_cluster,
                  res.frames.state.point_route)


def _port():
    from dr_using_scv_od_tpu_torch.models import pipeline
    return pipeline


def setup(doc, traffic, seed: int, device) -> State:
    cfg, _ = harness.port_configs(doc)
    wins = generator.render(traffic, seed, cfg.shapes.max_points)
    state = State(device=device, doc=doc, cfg=cfg,
                  pool=[_upload(w, device) for w in wins])
    _window(_port(), cfg, state.pool[0], 0)
    return state


def _run(state: State, k: int) -> Answer:
    ans = _window(_port(), state.cfg, state.pool[k % len(state.pool)],
                  k % len(state.pool))
    harness.sync(state.device)
    return ans


def window(state: State, seconds: float):
    answers: List[Answer] = []
    t0 = time.perf_counter()
    while True:
        answers.append(_run(state, len(answers)))
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    ms = elapsed * 1e3 / (len(answers) * state.frames)
    return answers, {"removal_ms_per_frame": ms}


def short(state: State) -> List[Answer]:
    """One pass over the pool (the control's readings of the program)."""
    return [_run(state, k) for k in range(len(state.pool))]


def _span_targets(sync_calls: bool):
    from dr_using_scv_od_tpu_torch.models import (patchwork, pipeline,
                                                  recognition, segmentation,
                                                  tracking)
    timed = [(patchwork, "estimate_ground", "patchwork"),
             (tracking, "track_window", "tracking")]
    if sync_calls:
        return timed
    return timed + [(segmentation, "segment_frame", "segmentation"),
                    (recognition, "recognize", "recognition"),
                    (pipeline, "_dynamic_bbox_sweep", "bbox_sweep"),
                    (pipeline, "run_window", "run_window")]


def traced(state: State):
    answers, wall_s = harness.timed(lambda: short(state), state.device)
    host = harness.Spans(state.device, False, _span_targets(False),
                         record=False)
    with host:
        profiled, trace = harness.profile(lambda: short(state),
                                          state.device)
    answers += profiled
    spans = harness.Spans(state.device, True, _span_targets(True))
    with spans:
        answers += short(state)
    print(f"[bench] pool pass with no profiler {wall_s:.3f} s, profiled "
          f"{trace.window_s:.3f} s", file=sys.stderr)
    frames = len(state.pool) * state.frames
    ctx = {"profiled_frames": frames, "wall_s": wall_s,
           "wall_frames": frames, "span_frames": frames,
           "span_s": dict(spans.seconds)}
    return answers, trace, host, ctx


# ---------------------------------------------------------------------------
# the reference and the comparison


def reference(state: State, control: str = ""):
    """The plain reference over the pool: (answers, occupied voxels of each
    frame's segmentation grid, in pool order). `control` runs it as the
    control of `correct` instead: "tf32" with TF32 matmuls, "bf16" with
    the points and intensities rounded to bfloat16 (harness.lower)."""
    from benchmark.reference import build
    from benchmark.reference.models import pipeline as ref_pipeline
    from benchmark.reference.ops import cluster_labels as ref_kernel
    cfg = build.pipeline_config(state.doc)
    occupied: List[int] = []
    plain = ref_kernel.cluster_labels

    def counted(occupied3, *args, **kwargs):
        occupied.append(int(occupied3.sum()))
        return plain(occupied3, *args, **kwargs)

    ref_kernel.cluster_labels = counted
    try:
        with harness.lower(control):
            answers = [
                _window(ref_pipeline, cfg,
                        (harness.lower_input(control, inputs[0]),
                         harness.lower_input(control, inputs[1]),
                         *inputs[2:]), k)
                for k, inputs in enumerate(state.pool)]
            harness.sync(state.device)
    finally:
        ref_kernel.cluster_labels = plain
    return answers, occupied


def compare(state: State, answer: Answer, ref: Answer) -> Dict[str, float]:
    valid = state.pool[answer.k][2]
    n = float(valid.sum())

    def share(a, b):
        return float(((a != b) & valid).sum()) / n

    return {"removed_diff_share": share(answer.removed, ref.removed),
            "route_diff_share": share(answer.point_route, ref.point_route),
            "cluster_diff_share": share(answer.point_cluster,
                                        ref.point_cluster)}


def readings(state: State, answers: List[Answer], refs: List[Answer]
             ) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
    """(worst reading of each number over `answers`, every answer's)."""
    each = [compare(state, a, refs[a.k]) for a in answers]
    worst = {k: max(e[k] for e in each) for k in each[0]}
    return worst, each


def control(state: State, mode: str = ""):
    """(worst readings of one program pass over the pool, of the control's
    in `mode` or None without one) against the reference."""
    program = short(state)
    refs, _ = reference(state)
    ctl = reference(state, mode)[0] if mode else None
    return (readings(state, program, refs)[0],
            readings(state, ctl, refs)[0] if ctl else None)


def check(state: State, answers: List[Answer], limits: Dict[str, float]):
    refs, occupied = reference(state)
    worst, each = readings(state, answers, refs)
    failed = sum(any(e[k] > limits[k] for k in limits) for e in each)
    checks = {k: (worst[k], limits[k]) for k in limits}
    extra = {"occupied_voxels": occupied,
             "grid_voxels": state.cfg.grid.bin_num}
    return checks, len(answers), failed, extra
