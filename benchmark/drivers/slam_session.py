"""Driver `slam_session`: online mapping with the streaming SLAM engine,
as `cli slam` runs it: whole sessions back to back, each a fresh
`SlamEngine` (WindowOutputs brought to the host, `materialize_outputs`)
fed every frame of the traffic's one window, then `finalize` and the
session's trajectory, loop edges and map read back. Identical sessions
keep the work a frame needs the same however fast the port becomes.

Set-up renders the frames from the seed, uploads them once and runs one
whole session, which warms every shape the cell uses (first, steady and
ERASOR windows, loop verification and the pose graph where the traffic
closes loops, finalize).

Timed: `slam_ms_per_frame`, the time from the start of the window to the
last window output read back (or, where a session ends past --seconds, to
its finalize read back), over all frames of the engine windows completed
in that time. The session that crosses --seconds stops after the window
that crosses it.

Traced: first one session with no profiler (it follows the warm-up, as
the timed window's sessions do), whose wall time the idle share is taken
against, with host-clock spans around the engine's `_window_odometry`
("odometry"), `_window_loops` ("loops"), `_run_pgo` ("pgo") and
`finalize` ("finalize", self time). Those spans do not synchronise: the
engine's host launches and reads leave the card idle most of a session, so
the host's time in a stage, its own waits for the card included, is what
the stage costs the session, and a synchronise would add waits the served
path does not have. Then one session under the profiler (device
activity only) with host-clock spans that name the idle gaps and put
nothing into the trace.

`correct`: every completed window and session against the plain
reference (`benchmark/reference`) run on the same frames: the largest
translation gap of a scan pose or an optimised keyframe pose, the share of
judged points whose dynamic verdict differs, the loop edges accepted by
one side only, the keyframe decisions that differ, and the share of static
map slots (after ERASOR) that differ.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from benchmark import harness
from benchmark.traffic import generator


class Session(NamedTuple):
    windows: List[Dict[str, np.ndarray]]
    final: Optional[Dict[str, np.ndarray]]      # None: cut by the window
    frames: int                                 # scans of its windows


@dataclasses.dataclass
class State:
    device: torch.device
    doc: Dict[str, Any]
    cfg: Any
    ec: Any
    frames: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # xyz, int, valid
    valid: np.ndarray                                        # [F, N] host

    @property
    def n_frames(self) -> int:
        return self.frames[0].shape[0]


def _port():
    from dr_using_scv_od_tpu_torch.models import engine
    return engine


def _session(engine_mod, cfg, ec, state: State,
             deadline: Optional[float] = None) -> Session:
    eng = engine_mod.SlamEngine(cfg, ec, materialize_outputs=True,
                                device=state.device)
    xyz, inten, valid = state.frames
    windows = []
    for f in range(state.n_frames):
        out = eng.feed(xyz[f], inten[f], valid[f])
        if out is None:
            continue
        windows.append({"removed": out.removed, "poses": out.poses,
                        "is_kf": out.is_kf,
                        "loops": out.loop_pair[out.loop_accepted]})
        if deadline is not None and time.perf_counter() >= deadline:
            return Session(windows, None, eng.n_frames)
    eng.finalize(final_erasor=True)
    n = eng.n_keyframes
    st = eng.state
    final = {"poses": eng.poses(), "kf_frames": eng.kf_frames(),
             "submap_valid": st.submap_valid.cpu().numpy(),
             "loops": np.stack([st.loop_i.cpu().numpy(),
                                st.loop_j.cpu().numpy()], 1)[
                                    :int(st.n_loops)],
             "n_keyframes": np.asarray(n)}
    return Session(windows, final, eng.n_frames)


def setup(doc, traffic, seed: int, device) -> State:
    cfg, ec = harness.port_configs(doc)
    (win,) = generator.render(traffic, seed, cfg.shapes.max_points)
    frames = tuple(torch.as_tensor(win[k]).to(device)
                   for k in ("xyz", "intensity", "valid"))
    state = State(device=device, doc=doc, cfg=cfg, ec=ec, frames=frames,
                  valid=win["valid"])
    _session(_port(), cfg, ec, state)
    return state


def window(state: State, seconds: float):
    sessions: List[Session] = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        sessions.append(_session(_port(), state.cfg, state.ec, state,
                                 deadline))
        t_last = time.perf_counter()
        if t_last >= deadline:
            break
    frames = sum(s.frames for s in sessions)
    return sessions, {"slam_ms_per_frame": (t_last - t0) * 1e3 / frames}


def short(state: State) -> List[Session]:
    """One whole session (the control's readings of the program)."""
    return [_session(_port(), state.cfg, state.ec, state)]


def _span_targets(naming: bool):
    """The stages the span metrics read; with `naming` also the calls that
    only name the profiled session's idle gaps."""
    from dr_using_scv_od_tpu_torch.models import (engine, pipeline,
                                                  scan_context)
    timed = [(engine, "_window_odometry", "odometry"),
             (engine, "_window_loops", "loops"),
             (engine, "_run_pgo", "pgo"),
             (engine, "finalize", "finalize")]
    if not naming:
        return timed
    return timed + [(engine, "process_window", "process_window"),
                    (engine, "_keyframe_gate", "keyframe_gate"),
                    (scan_context, "descriptor", "descriptor"),
                    (pipeline, "run_window", "run_window"),
                    (engine, "_insert_submaps", "submaps"),
                    (engine, "_erasor_pass", "erasor")]


def traced(state: State):
    spans = harness.Spans(state.device, False, _span_targets(False),
                          record=False)
    with spans:
        sessions, wall_s = harness.timed(lambda: short(state), state.device)
    host = harness.Spans(state.device, False, _span_targets(True),
                         record=False)
    with host:
        profiled, trace = harness.profile(lambda: short(state), state.device)
    sessions += profiled
    print(f"[bench] session with no profiler {wall_s:.3f} s, profiled "
          f"{trace.window_s:.3f} s", file=sys.stderr)
    ctx = {"profiled_frames": sessions[1].frames, "wall_s": wall_s,
           "wall_frames": sessions[0].frames,
           "span_frames": sessions[0].frames,
           "span_s": dict(spans.seconds),
           "span_self_s": dict(spans.self_seconds)}
    return sessions, trace, host, ctx


# ---------------------------------------------------------------------------
# the reference and the comparison


def reference(state: State, control: str = "") -> Session:
    """The plain reference's session over the same frames. `control` runs
    it as the control of `correct` instead (harness.lower)."""
    from benchmark.reference import build
    from benchmark.reference.models import engine as ref_engine
    xyz, inten, valid = state.frames
    lowered = dataclasses.replace(state, frames=(
        harness.lower_input(control, xyz),
        harness.lower_input(control, inten), valid))
    with harness.lower(control):
        return _session(ref_engine, build.pipeline_config(state.doc),
                        build.engine_config(state.doc), lowered)


def _pose_gap(a: np.ndarray, b: np.ndarray) -> float:
    n = min(len(a), len(b))
    if n == 0:
        return 0.0
    return float(np.linalg.norm(a[:n, :3, 3].astype(np.float64)
                                - b[:n, :3, 3], axis=-1).max())


def _pairs(p: np.ndarray) -> set:
    return {tuple(int(v) for v in row) for row in p}


def compare(state: State, session: Session, ref: Session
            ) -> List[Dict[str, float]]:
    """One reading of each number per window of `session` (the session's
    final outputs count with its last window)."""
    W = state.ec.window
    out = []
    for j, (w, r) in enumerate(zip(session.windows, ref.windows)):
        start = (W - 1) * j
        valid = state.valid[start:start + w["removed"].shape[0]]
        out.append({
            "pose_gap_m": _pose_gap(w["poses"], r["poses"]),
            "removed_diff_share": float(((w["removed"] != r["removed"])
                                         & valid).sum()) / float(valid.sum()),
            "loop_edge_diff": float(len(_pairs(w["loops"])
                                        ^ _pairs(r["loops"]))),
            "keyframe_diff": float((w["is_kf"] != r["is_kf"]).sum()),
            "map_diff_share": 0.0})
    if len(session.windows) > len(ref.windows):
        raise RuntimeError("the program ran more windows than the reference")
    if session.final is not None:
        a, b = session.final, ref.final
        last = out[-1]
        last["pose_gap_m"] = max(last["pose_gap_m"],
                                 _pose_gap(a["poses"], b["poses"]))
        last["keyframe_diff"] += abs(float(a["n_keyframes"])
                                     - float(b["n_keyframes"]))
        last["loop_edge_diff"] += float(len(_pairs(a["loops"])
                                            ^ _pairs(b["loops"])))
        last["map_diff_share"] = (float((a["submap_valid"]
                                         != b["submap_valid"]).sum())
                                  / max(1.0, float(b["submap_valid"].sum())))
    return out


def readings(state: State, sessions: List[Session], ref: Session
             ) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
    """(worst reading of each number over `sessions`, every window's)."""
    each = [r for s in sessions for r in compare(state, s, ref)]
    worst = {k: max(e[k] for e in each) for k in each[0]}
    return worst, each


def control(state: State, mode: str = ""):
    """(worst readings of one program session, of the control's session in
    `mode` or None without one) against the reference."""
    program = short(state)
    ref = reference(state)
    ctl = reference(state, mode) if mode else None
    return (readings(state, program, ref)[0],
            readings(state, [ctl], ref)[0] if ctl else None)


def check(state: State, sessions: List[Session], limits: Dict[str, float]):
    ref = reference(state)
    done = [s.final for s in sessions if s.final]
    print("[bench] finished sessions: keyframes the gate accepted "
          f"{[int(f['n_keyframes']) for f in done]}, loop edges "
          f"{[len(f['loops']) for f in done]}; reference "
          f"{int(ref.final['n_keyframes'])} keyframes, "
          f"{len(ref.final['loops'])} loop edges, of {state.n_frames} scans",
          file=sys.stderr)
    worst, each = readings(state, sessions, ref)
    failed = sum(any(e[k] > limits[k] for k in limits) for e in each)
    checks = {k: (worst[k], limits[k]) for k in limits}
    return checks, len(each), failed, {}
