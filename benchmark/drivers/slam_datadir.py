"""Driver `slam_datadir`: a recorded drive mapped from disk, as `cli slam
--data <dir>` runs it. Each session opens the port's scan stream
(`cli.stream_scans`: the prefetch ring decodes the `.bin` files ahead, the
host keeps the first point of each 0.08 m leaf and pads the scan) over a
KITTI-layout directory and feeds every scan it yields to a fresh
`SlamEngine` (WindowOutputs brought to the host, `materialize_outputs`),
which uploads it, then runs `finalize` and reads the session's
trajectory, loop edges and map back, as `drivers/slam_session.py` does
with scans already on the card.

Set-up renders the traffic's scans from the seed and writes them as the
configuration's `input` says: scan k is the file k * skip of
`sequences/00/velodyne/`, float32 x, y, z and reflectance (intensity over
`max_intensity`, in [0, 1]), and the files between are hard links to the
scan before them, which the stream lists and never decodes. The
directory lies in a temporary directory, so its files are in the page
cache. Then one whole session warms every shape the cell uses.

Timed: `slam_ms_per_frame`, from the start of the window to the last
window output read back (or, where a session ends past --seconds, to its
finalize read back), over all frames of the engine windows completed in
that time. The session that crosses --seconds stops after the window that
crosses it and closes its stream, which frees the prefetch reader.

Traced: one session in the port's `timing.recording()` with no profiler,
whose wall time the idle share is taken against and whose record
(`stream_record`) holds the stream's spans and counts; then one session
under the profiler (device activity only), also in `recording()`, whose
spans name the idle gaps.

`correct`: every scan the stream yielded against the plain reference
reader (`benchmark/reference/scan_stream.py`) on the same files
(`scan_diff_points`, the points of a window's scans that differ in a bit
of xyz, intensity or validity), and every completed window and session
against the plain reference engine fed the reference reader's scans, with
`slam_session`'s comparison.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import scan_stream
from benchmark.traffic import generator, synthetic

Scan = scan_stream.Scan


def _slam():
    return harness.load_module("drivers", "slam_session")


class Streamed(NamedTuple):
    session: Any              # slam_session.Session
    scans: List[Scan]         # what the stream yielded, in order


@dataclasses.dataclass
class State:
    device: torch.device
    doc: Dict[str, Any]
    cfg: Any
    ec: Any
    root: tempfile.TemporaryDirectory
    data: Path                # the velodyne directory

    @property
    def input(self) -> Dict[str, Any]:
        return self.doc["input"]


def write_sequence(scene: synthetic.Scene, frames: int, inp: Dict[str, Any],
                   max_intensity: float, root: Path) -> Path:
    """Scan k of `scene` as the file k * skip of `inp["layout"]` under
    `root`, the files up to the next scan hard links to it; returns the
    directory."""
    path = lambda i: root / (inp["layout"] % i)
    path(0).parent.mkdir(parents=True, exist_ok=True)
    skip = inp["skip"]
    for k in range(frames):
        xyz, inten, _, _ = synthetic.render_frame(scene, k)
        pts = np.empty((len(xyz), 4), np.float32)
        pts[:, :3] = xyz
        pts[:, 3] = np.clip(inten / np.float32(max_intensity), 0, 1)
        first = path(k * skip)
        pts.tofile(first)
        for j in range(1, skip):
            os.link(first, path(k * skip + j))
    return path(0).parent


def _session(state: State, deadline: Optional[float] = None) -> Streamed:
    from dr_using_scv_od_tpu_torch import cli
    from dr_using_scv_od_tpu_torch.models import engine
    Session = _slam().Session
    scans, _ = cli.stream_scans(state.data, state.cfg,
                                start=state.input["start"],
                                end=state.input["end"])
    eng = engine.SlamEngine(state.cfg, state.ec, materialize_outputs=True,
                            device=state.device)
    fed: List[Scan] = []
    windows = []
    try:
        for scan in scans:
            fed.append(scan)
            out = eng.feed(*scan)
            if out is None:
                continue
            windows.append({"removed": out.removed, "poses": out.poses,
                            "is_kf": out.is_kf,
                            "loops": out.loop_pair[out.loop_accepted]})
            if deadline is not None and time.perf_counter() >= deadline:
                return Streamed(Session(windows, None, eng.n_frames), fed)
    finally:
        scans.close()
    eng.finalize(final_erasor=True)
    st = eng.state
    final = {"poses": eng.poses(), "kf_frames": eng.kf_frames(),
             "submap_valid": st.submap_valid.cpu().numpy(),
             "loops": np.stack([st.loop_i.cpu().numpy(),
                                st.loop_j.cpu().numpy()], 1)[
                                    :int(st.n_loops)],
             "n_keyframes": np.asarray(eng.n_keyframes)}
    return Streamed(Session(windows, final, eng.n_frames), fed)


def setup(doc, traffic, seed: int, device) -> State:
    cfg, ec = harness.port_configs(doc)
    inp = doc["input"]
    if (inp["skip"], inp["padded_points"]) != (cfg.skip,
                                                cfg.shapes.max_points):
        raise ValueError("the input's skip and padding are not the "
                         "pipeline's")
    root = tempfile.TemporaryDirectory(prefix="slam-datadir-")
    data = write_sequence(generator.scene(traffic, seed, 0),
                          traffic["frames"], inp, cfg.max_intensity,
                          Path(root.name))
    state = State(device=device, doc=doc, cfg=cfg, ec=ec, root=root,
                  data=data)
    _session(state)
    return state


def window(state: State, seconds: float):
    streamed: List[Streamed] = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        streamed.append(_session(state, deadline))
        t_last = time.perf_counter()
        if t_last >= deadline:
            break
    frames = sum(s.session.frames for s in streamed)
    return streamed, {"slam_ms_per_frame": (t_last - t0) * 1e3 / frames}


def short(state: State) -> List[Streamed]:
    """One whole session (the control's readings of the program)."""
    return [_session(state)]


def traced(state: State):
    from dr_using_scv_od_tpu_torch.utils import timing
    with timing.recording() as rec:
        sessions, wall_s = harness.timed(lambda: short(state), state.device)
    with timing.recording() as named:
        profiled, trace = harness.profile(lambda: short(state), state.device)
    print(f"[bench] session with no profiler {wall_s:.3f} s, profiled "
          f"{trace.window_s:.3f} s", file=sys.stderr)
    frames = sessions[0].session.frames
    ctx = {"profiled_frames": profiled[0].session.frames, "wall_s": wall_s,
           "wall_frames": frames, "span_frames": frames,
           "stream_record": rec}
    return sessions + profiled, trace, named, ctx


# ---------------------------------------------------------------------------
# the reference and the comparison


def reference_scans(state: State) -> List[Scan]:
    """The plain reader's scans of the same files, from the configuration's
    numbers alone."""
    inp = state.input
    return scan_stream.read_sequence(
        state.data, inp["start"], inp["end"], inp["skip"],
        state.doc["pipeline"]["max_intensity"], inp["downsample_leaf_m"],
        inp["decode_cap_points"], inp["padded_points"])


def _reference_state(state: State, scans: List[Scan]):
    """slam_session's state over the reference reader's scans, on the
    card, for its reference engine and its comparison."""
    stacked = [np.stack(a) for a in zip(*scans)]
    return _slam().State(
        device=state.device, doc=state.doc, cfg=state.cfg, ec=state.ec,
        frames=tuple(torch.as_tensor(a).to(state.device) for a in stacked),
        valid=stacked[2])


def diff_points(a: Scan, b: Scan) -> int:
    """Points of two padded scans that differ in a bit of xyz, intensity
    or validity."""
    xyz = (a[0].view(np.uint32) != b[0].view(np.uint32)).any(axis=1)
    inten = a[1].view(np.uint32) != b[1].view(np.uint32)
    return int((xyz | inten | (a[2] != b[2])).sum())


def _scan_diffs(scans: List[Scan], ref: List[Scan], windows: int,
                W: int) -> List[float]:
    """diff_points summed over the scans each window took in (the first
    window W, each later one W - 1; scans fed after the last window count
    with it)."""
    if len(scans) > len(ref):
        raise RuntimeError("the stream yielded more scans than the "
                           "reference reads")
    ends = [W + (W - 1) * j for j in range(windows)]
    ends[-1] = len(scans)
    out, lo = [], 0
    for hi in ends:
        out.append(float(sum(diff_points(scans[i], ref[i])
                             for i in range(lo, hi))))
        lo = hi
    return out


def readings(ref_state, streamed: List[Streamed], ref_scans: List[Scan],
             ref) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
    """(worst reading of each number over `streamed`, every window's)."""
    each = []
    for s in streamed:
        got = _slam().compare(ref_state, s.session, ref)
        for r, d in zip(got, _scan_diffs(s.scans, ref_scans, len(got),
                                          ref_state.ec.window)):
            r["scan_diff_points"] = d
        each += got
    worst = {k: max(e[k] for e in each) for k in each[0]}
    return worst, each


def control(state: State, mode: str = ""):
    """(worst readings of one program session, of the control's session in
    `mode` or None without one) against the reference: the control is the
    reference reader's scans lowered as harness.lower_input does (they are
    unchanged under "tf32") through the reference engine in `mode`."""
    slam = _slam()
    program = short(state)
    ref_scans = reference_scans(state)
    ref_state = _reference_state(state, ref_scans)
    ref = slam.reference(ref_state)
    ctl = None
    if mode:
        lowered = [tuple(harness.lower_input(mode, torch.as_tensor(a))
                         .numpy() for a in s[:2]) + (s[2],)
                   for s in ref_scans]
        session = slam.reference(ref_state, mode)
        ctl = readings(ref_state, [Streamed(session, lowered)], ref_scans,
                       ref)[0]
    return readings(ref_state, program, ref_scans, ref)[0], ctl


def check(state: State, streamed: List[Streamed],
          limits: Dict[str, float]):
    ref_scans = reference_scans(state)
    ref_state = _reference_state(state, ref_scans)
    ref = _slam().reference(ref_state)
    done = [s.session.final for s in streamed if s.session.final]
    kept = [int(v.sum()) for _, _, v in ref_scans]
    print("[bench] finished sessions: keyframes the gate accepted "
          f"{[int(f['n_keyframes']) for f in done]}, loop edges "
          f"{[len(f['loops']) for f in done]}; reference "
          f"{int(ref.final['n_keyframes'])} keyframes, "
          f"{len(ref.final['loops'])} loop edges, of {len(ref_scans)} "
          f"scans of {min(kept)}-{max(kept)} points kept",
          file=sys.stderr)
    worst, each = readings(ref_state, streamed, ref_scans, ref)
    failed = sum(any(e[k] > limits[k] for k in limits) for e in each)
    checks = {k: (worst[k], limits[k]) for k in limits}
    return checks, len(each), failed, {}
