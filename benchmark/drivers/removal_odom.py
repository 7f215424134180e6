"""Driver `removal_odom`: offline dynamic removal of a drive recorded
without poses, as `cli segdf --estimate-poses` runs it: a closed loop of
back-to-back `pipeline.segdf_window` calls with `estimate_poses`, each
over one whole window of the traffic's pool (scan-to-scan GICP over the
window's F - 1 pairs, then `run_window` on the poses it estimated), the
device synchronised after each.

Set-up renders `removal_window`'s pool from the seed, uploads the scans
alone (no pose reaches the program) and runs one window to warm every
shape. The scene's poses stay on the host, for the ATE that the check
prints and nothing else.

Timed: `removal_ms_per_frame`, the window's wall time, odometry included,
over the frames of all windows completed in it (the last one ends at or
after --seconds).

Traced: one pass over the pool in the port's `timing.recording()` with no
profiler, whose wall time the idle share is taken against; then one pass
under the profiler (device activity only), also in `recording()`, whose
spans name the idle gaps. The per-layer metrics that read the port's
record take their own passes (`program_record`).

`correct`: every window against the plain reference's odometry and
`run_window` (`benchmark/reference`) on the same scans, the reference on
the poses it estimated itself: `pose_gap_m`, the largest translation gap
between the program's and the reference's poses of a window, and
`removal_window`'s shares of valid points whose dynamic verdict, route or
final cluster differs; the worst window of the run for each.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from benchmark import harness
from benchmark.traffic import generator


def _removal():
    return harness.load_module("drivers", "removal_window")


class Answer(NamedTuple):
    k: int                     # pool window
    removed: torch.Tensor      # [F, N] bool
    point_cluster: torch.Tensor    # [F, N] int32
    point_route: torch.Tensor      # [F, N] int32
    poses: torch.Tensor        # [F, 4, 4] the estimated poses


@dataclasses.dataclass
class State:
    device: torch.device
    doc: Dict[str, Any]
    cfg: Any
    entry: Any                 # the port's pipeline.segdf_window
    pool: List[Tuple[torch.Tensor, ...]]     # (xyz, intensity, valid)
    scene_poses: List[np.ndarray]            # [F, 4, 4], for the ATE only

    @property
    def frames(self) -> int:
        return self.pool[0][0].shape[0]


def _upload(win, device) -> Tuple[torch.Tensor, ...]:
    return (torch.as_tensor(win["xyz"], dtype=torch.float32).to(device),
            torch.as_tensor(win["intensity"], dtype=torch.float32).to(device),
            torch.as_tensor(win["valid"], dtype=torch.bool).to(device))


def _answer(k: int, poses: torch.Tensor, res) -> Answer:
    return Answer(k, res.removed, res.point_cluster,
                  res.frames.state.point_route, poses)


def setup(doc, traffic, seed: int, device) -> State:
    # looked up first, so that a port without the entry fails at once
    from dr_using_scv_od_tpu_torch.models import pipeline
    entry = pipeline.segdf_window
    cfg, _ = harness.port_configs(doc)
    wins = generator.render(traffic, seed, cfg.shapes.max_points)
    state = State(device=device, doc=doc, cfg=cfg, entry=entry,
                  pool=[_upload(w, device) for w in wins],
                  scene_poses=[np.asarray(w["poses"], np.float64)
                               for w in wins])
    _run(state, 0)
    return state


def _run(state: State, k: int) -> Answer:
    k %= len(state.pool)
    out = state.entry(*state.pool[k], None, state.cfg, estimate_poses=True)
    harness.sync(state.device)
    return _answer(k, out.poses, out.window)


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
    """One pass over the pool (the control's readings of the program, and
    the passes of program_record)."""
    return [_run(state, k) for k in range(len(state.pool))]


def traced(state: State):
    from dr_using_scv_od_tpu_torch.utils import timing
    with timing.recording():
        answers, wall_s = harness.timed(lambda: short(state), state.device)
    with timing.recording() as named:
        profiled, trace = harness.profile(lambda: short(state),
                                          state.device)
    print(f"[bench] pool pass with no profiler {wall_s:.3f} s, profiled "
          f"{trace.window_s:.3f} s", file=sys.stderr)
    frames = len(state.pool) * state.frames
    ctx = {"profiled_frames": frames, "wall_s": wall_s,
           "wall_frames": frames, "span_frames": frames}
    return answers + profiled, trace, named, ctx


# ---------------------------------------------------------------------------
# the reference and the comparison


def reference(state: State, control: str = "") -> List[Answer]:
    """The plain reference over the pool: its own odometry, then its
    run_window on the poses it estimated. `control` runs it as the control
    of `correct` instead: "tf32" with TF32 matmuls, "bf16" with the points
    and intensities rounded to bfloat16 (harness.lower)."""
    from benchmark.reference import build
    from benchmark.reference.models import odometry as ref_odometry
    from benchmark.reference.models import pipeline as ref_pipeline
    cfg = build.pipeline_config(state.doc)
    answers = []
    with harness.lower(control):
        for k, (xyz, intensity, valid) in enumerate(state.pool):
            xyz = harness.lower_input(control, xyz)
            intensity = harness.lower_input(control, intensity)
            poses = ref_odometry.estimate_window_poses(xyz, valid, cfg).poses
            res = ref_pipeline.run_window(xyz, intensity, valid, poses, cfg)
            answers.append(_answer(k, poses, res))
        harness.sync(state.device)
    return answers


def compare(state: State, answer: Answer, ref: Answer) -> Dict[str, float]:
    gap = torch.linalg.vector_norm(
        answer.poses[:, :3, 3].double() - ref.poses[:, :3, 3].double(),
        dim=-1)
    return {"pose_gap_m": float(gap.max()),
            **_removal().compare(state, answer, ref)}


def readings(state: State, answers: List[Answer], refs: List[Answer]
             ) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
    """(worst reading of each number over `answers`, every answer's)."""
    each = [compare(state, a, refs[a.k]) for a in answers]
    worst = {k: max(e[k] for e in each) for k in each[0]}
    return worst, each


def ate_m(state: State, answer: Answer) -> float:
    """RMSE of the translations of a window's estimated poses against the
    scene's, both taken relative to their first pose."""
    def rel(p):
        return (np.linalg.inv(p[0]) @ p)[:, :3, 3]
    est = answer.poses.cpu().double().numpy()
    gt = state.scene_poses[answer.k]
    return float(np.sqrt(((rel(est) - rel(gt)) ** 2).sum(-1).mean()))


def control(state: State, mode: str = ""):
    """(worst readings of one program pass over the pool, of the control's
    in `mode` or None without one) against the reference."""
    program = short(state)
    refs = reference(state)
    ctl = reference(state, mode) if mode else None
    return (readings(state, program, refs)[0],
            readings(state, ctl, refs)[0] if ctl else None)


def check(state: State, answers: List[Answer], limits: Dict[str, float]):
    refs = reference(state)
    worst, each = readings(state, answers, refs)
    first: Dict[int, Answer] = {}
    for a in answers:
        first.setdefault(a.k, a)
    program = [ate_m(state, first[k]) for k in sorted(first)]
    print("[bench] ATE (m) of each pool window's estimated poses against "
          f"the scene's: program {program}, reference "
          f"{[ate_m(state, r) for r in refs]}", file=sys.stderr)
    failed = sum(any(e[k] > limits[k] for k in limits) for e in each)
    checks = {k: (worst[k], limits[k]) for k in limits}
    return checks, len(answers), failed, {}
