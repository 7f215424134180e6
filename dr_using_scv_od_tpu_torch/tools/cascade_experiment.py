"""Cascade experiment on the port (counterpart of
tools/cascade_experiment.py): can the reference's IN-LOOP mutation order
produce its published falling-RR-vs-occupancy trend?

A sequential NumPy oracle of the tracking lattice with the reference's
in-loop semantics (src/ssc.cpp:1250-1426: remap probes and ratio
denominators read the current mutated state; splits and merges apply
immediately) chains over a synthetic window with moving and parked cars,
and RR / PR are measured per occupancy threshold, beside the port's
pre-mutation-snapshot formulation (models/tracking.py) on the same
segmented frames. The cluster iteration order is a parameter (ascending,
descending, shuffled), because the reference iterates an unordered_map.
The oracle is a copy of the JAX tool's; the frames are segmented and
tracked by the port, on an explicit device.

    python -m dr_using_scv_od_tpu_torch.tools.cascade_experiment \
        [--frames 40] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from .. import config, interop
from ..eval import metrics
from ..models import pipeline, tracking
from ..ops import geometry, quantize
from ..types import ClusterTable
from ..utils import synthetic
from .profile_stages import require_device

INT_MAX = np.iinfo(np.int64).max


def oracle_pair_inloop(cur, nxt, pts, T_np, counter, cfg, occ, order, rng):
    """One tracking pair with the reference's IN-LOOP mutation semantics
    (src/ssc.cpp:1250-1426, no pre-mutation snapshot):

      * clusters iterate in `order` ('asc'/'desc'/'shuffle' - the
        reference's unordered_map order is arbitrary);
      * the remap probe reads the CURRENT next-frame label grid
        (hash_cloud labels mutate as splits/merges land, :1307);
      * the overlap denominator reads the CURRENT occupy_voxels size
        (:1336) - a cluster shrunk by an earlier split offers a smaller
        denominator to later clusters;
      * splits carve the hit voxels out of the target immediately
        (:1355-1374); merges erase absorbed rows immediately (:1396-1421).

    `cur`/`nxt`: dicts with 'grid' [G], 'valid' [C], 'type' [C],
    'nvox' [C], 'tid' [C], 'state' [C] (mutated in place for `nxt`).
    `pts`: dict with 'pc' [N] prev cluster per point, 'wflat' [N] warped
    next-frame voxel, 'in_fov' [N].
    """
    C = len(cur["valid"])
    TYPE_CAR = 2
    n_dyn = n_split = n_merge = 0

    rows = [c for c in range(C)
            if cur["valid"][c] and cur["type"][c] == TYPE_CAR]
    if order == "desc":
        rows = rows[::-1]
    elif order == "shuffle":
        rng.shuffle(rows)

    # fresh track ids (ascending, ssc.cpp:1266-1271)
    for c in rows:
        if cur["tid"][c] == -1:
            cur["tid"][c] = counter
            counter += 1

    free_rows = iter([r for r in range(C) if not nxt["valid"][r]])
    pc, wflat, in_fov = pts["pc"], pts["wflat"], pts["in_fov"]

    for c in rows:
        mask = pc == c
        if not mask.any():
            continue
        # remap against the CURRENT (mutated) grid
        ks = np.nonzero(mask & in_fov)[0]
        if len(ks) == 0:
            # reference: zero probes -> remap empty -> dynamic
            cur["state"][c] = 1
            n_dyn += 1
            continue
        labs = nxt["grid"][wflat[ks]]
        hit = labs >= 0
        remap = {}
        for l, v in zip(labs[hit], wflat[ks][hit]):
            remap.setdefault(int(l), set()).add(int(v))

        if len(remap) == 0:
            cur["state"][c] = 1
            n_dyn += 1
        elif len(remap) == 1:
            l, vs = next(iter(remap.items()))
            ratio = len(vs) / max(int(nxt["nvox"][l]), 1)
            if ratio < occ:
                if nxt["type"][l] == TYPE_CAR:
                    cur["state"][c] = 1
                    n_dyn += 1
                else:
                    cur["state"][c] = 0
                    cur["type"][c] = int(nxt["type"][l])
                    r = next(free_rows, None)
                    if r is not None:
                        # carve IMMEDIATELY (in-loop cascade)
                        n_split += 1
                        vlist = np.fromiter(vs, np.int64)
                        nxt["grid"][vlist] = r
                        nxt["valid"][r] = True
                        nxt["type"][r] = int(nxt["type"][l])
                        nxt["tid"][r] = int(cur["tid"][c])
                        nxt["nvox"][r] = len(vs)
                        nxt["nvox"][l] = max(int(nxt["nvox"][l]) - len(vs),
                                             0)
            else:
                if nxt["type"][l] == TYPE_CAR:
                    cur["state"][c] = 0
                    if nxt["tid"][l] == -1:
                        nxt["tid"][l] = int(cur["tid"][c])
        else:
            cur["state"][c] = 0
            qual = [l for l, vs in remap.items()
                    if nxt["type"][l] == TYPE_CAR
                    and len(vs) / max(int(nxt["nvox"][l]), 1) >= occ]
            if qual:
                r = next(free_rows, None)
                if r is not None:
                    # absorb IMMEDIATELY
                    n_merge += 1
                    total = 0
                    for l in qual:
                        sel = nxt["grid"] == l
                        nxt["grid"][sel] = r
                        total += int(sel.sum())
                        nxt["valid"][l] = False
                        nxt["nvox"][l] = 0
                    nxt["valid"][r] = True
                    nxt["type"][r] = TYPE_CAR
                    nxt["tid"][r] = int(cur["tid"][c])
                    nxt["nvox"][r] = total
    return counter, (n_dyn, n_split, n_merge)


def prepare_frames(cfg, F, spec=None, *, device):
    """Segment a synthetic window once on `device`; both methods consume
    the same per-frame tables and grids (numpy). Returns (window dict,
    per-frame dicts, per-pair warped voxels)."""
    spec = spec or synthetic.SceneSpec(
        n_moving_cars=3, n_parked_cars=8, wall_parked_cars=1,
        ground_pts=9000, building_pts=1500, tree_pts=400, car_pts=420,
        mover_path="pingpong", stop_frame=F // 2)
    win = synthetic.render_window(synthetic.make_scene(spec), F,
                                  cfg.shapes.max_points)
    st = pipeline.process_window(*interop.window_from_numpy(win, device),
                                 cfg).state
    out = []
    for t in range(F):
        out.append(dict(
            xyz=st.points.xyz[t].cpu().numpy(),
            valid=st.points.valid[t].cpu().numpy(),
            pv=st.point_voxel[t].cpu().numpy(),
            grid=st.label_grid[t].cpu().numpy(),
            tvalid=st.clusters.valid[t].cpu().numpy(),
            ttype=st.clusters.type[t].cpu().numpy(),
            tnvox=st.clusters.n_voxels[t].cpu().numpy(),
        ))
    # per-pair warped voxels (shared by both methods)
    poses = torch.tensor(win["poses"], dtype=torch.float32, device=device)
    pair_pts = []
    for t in range(F - 1):
        T_np = (geometry.inverse_se3(poses[t + 1]) @ poses[t]).cpu().numpy()
        f = out[t]
        h = np.concatenate([f["xyz"], np.ones((len(f["xyz"]), 1),
                                              np.float32)], 1)
        warped = (h @ T_np.T)[:, :3].astype(np.float32)
        ok = f["valid"] & (f["pv"] >= 0)
        _, wflat, in_fov = quantize.quantize(
            torch.tensor(warped, device=device),
            torch.tensor(ok, device=device), cfg.grid)
        pair_pts.append(dict(wflat=np.clip(wflat.cpu().numpy(), 0, None),
                             in_fov=in_fov.cpu().numpy(), ok=ok))
    return win, out, pair_pts


def oracle_window(frames_np, pair_pts, cfg, occ, order="asc", seed=0):
    """Chain the in-loop oracle over the window; returns removed [F-1, N]
    (per-point dynamic verdicts for judged frames, run_window's rule)."""
    rng = np.random.default_rng(seed)
    F = len(frames_np)
    C = cfg.shapes.max_clusters

    def fresh(f):
        return dict(grid=f["grid"].copy(), valid=f["tvalid"].copy(),
                    type=f["ttype"].copy(), nvox=f["tnvox"].copy(),
                    tid=np.full(C, -1, np.int64),
                    state=np.full(C, -1, np.int64))

    cur = fresh(frames_np[0])
    counter = 0
    removed = []
    muts = np.zeros(3, np.int64)   # (dyn, split, merge) totals
    for t in range(F - 1):
        nxt = fresh(frames_np[t + 1])
        # carry mutated next state across pairs: grid/valid/type/tid of
        # frame t+1 as mutated by this pair feed pair t+1 (segDF chains
        # tracking(frame[i], frame[i+1]) over the window,
        # src/ssc.cpp:1450-1452)
        f = frames_np[t]
        pc = np.where(f["valid"] & (f["pv"] >= 0),
                      cur["grid"][np.clip(f["pv"], 0, None)], -1)
        pts = dict(pc=pc, wflat=pair_pts[t]["wflat"],
                   in_fov=pair_pts[t]["in_fov"])
        counter, stats = oracle_pair_inloop(cur, nxt, pts, None, counter,
                                            cfg, occ, order, rng)
        muts += np.asarray(stats)
        # frame t verdicts are now final: point removed iff its cluster
        # (in frame t's final grid) is dynamic
        lab = np.where(f["valid"] & (f["pv"] >= 0),
                       cur["grid"][np.clip(f["pv"], 0, None)], -1)
        st = np.where(lab >= 0, cur["state"][np.clip(lab, 0, C - 1)], -1)
        removed.append((lab >= 0) & (st == 1))
        cur = nxt
    oracle_window.last_muts = muts   # (dyn, split, merge) diagnostics
    return np.stack(removed)


def ours_window(frames_np, cfg, occ, win, *, device):
    """The port's deterministic formulation (tracking.track_window) on the
    same frames, on `device`; returns removed [F-1, N]."""
    F = len(frames_np)
    C = cfg.shapes.max_clusters
    cfg_t = dataclasses.replace(
        cfg, track=dataclasses.replace(cfg.track, occupancy=occ,
                                       dynamic_bbox_sweep=False))

    def stacked(key):
        return np.stack([f[key] for f in frames_np])

    tables = interop.cluster_table_from_numpy(dict(
        valid=stacked("tvalid"), n_points=np.zeros((F, C), np.int32),
        n_voxels=stacked("tnvox"),
        bbox_min=np.zeros((F, C, 3), np.float32),
        bbox_max=np.zeros((F, C, 3), np.float32), type=stacked("ttype"),
        state=np.full((F, C), -1, np.int32),
        track_id=np.full((F, C), -1, np.int32)), device)

    def on_device(a, dtype):
        return torch.tensor(a, dtype=dtype, device=device)

    tr = tracking.track_window(
        on_device(stacked("xyz"), torch.float32),
        on_device(stacked("pv"), torch.int32),
        on_device(np.stack([f["valid"] & (f["pv"] >= 0) for f in frames_np]),
                  torch.bool),
        on_device(stacked("grid"), torch.int32), tables,
        on_device(win["poses"], torch.float32), cfg_t)
    lg = tr.label_grids.cpu().numpy()
    states = tr.tables.state.cpu().numpy()
    removed = []
    for t in range(F - 1):
        f = frames_np[t]
        lab = np.where(f["valid"] & (f["pv"] >= 0),
                       lg[t][np.clip(f["pv"], 0, None)], -1)
        st = np.where(lab >= 0, states[t][np.clip(lab, 0, C - 1)], -1)
        removed.append((lab >= 0) & (st == 1))
    return np.stack(removed)


def experiment_config() -> config.PipelineConfig:
    """The experiment's configuration: semantickitti() on a coarser grid
    (2.4 degree sectors, 4 degree azimuth bins) at 16,384 points, 256
    clusters and 4,096 tracked points."""
    cfg = config.semantickitti()
    return cfg.replace(
        grid=dataclasses.replace(cfg.grid, sector_res=2.4, azimuth_res=4.0),
        shapes=dataclasses.replace(cfg.shapes, max_points=16384,
                                   max_clusters=256, max_track_points=4096))


def run_experiment(F=40, occupancies=(0.2, 0.5, 0.8),
                   orders=("asc", "desc", "shuffle"), cfg=None,
                   device="cuda"):
    """{occupancy: {method: (PR, RR), "muts": {order: (dyn, split,
    merge)}}} over one segmented window of F frames on `device` (raises if
    it is missing)."""
    device = require_device(device)
    cfg = cfg or experiment_config()
    win, frames_np, pair_pts = prepare_frames(cfg, F, device=device)
    gt = win["label"][:F - 1].reshape(-1)
    va = win["valid"][:F - 1].reshape(-1)

    results = {}
    for occ in occupancies:
        row = {}
        for order in orders:
            rem = oracle_window(frames_np, pair_pts, cfg, occ, order)
            m = metrics.removal_metrics(gt, rem.reshape(-1), va)
            row[f"oracle-{order}"] = (m.pr, m.rr)
            row.setdefault("muts", {})[order] = tuple(
                int(x) for x in oracle_window.last_muts)
        rem = ours_window(frames_np, cfg, occ, win, device=device)
        m = metrics.removal_metrics(gt, rem.reshape(-1), va)
        row["ours"] = (m.pr, m.rr)
        results[occ] = row
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run_experiment(F=args.frames, device=args.device)
    methods = [m for m in next(iter(res.values())) if m != "muts"]
    print("| occupancy | " + " | ".join(f"{m} PR/RR" for m in methods)
          + " |")
    print("|---" * (len(methods) + 1) + "|")
    for occ, row in sorted(res.items()):
        cells = " | ".join(f"{row[m][0]:.2f}/{row[m][1]:.2f}"
                           for m in methods)
        print(f"| {occ:.1f} | {cells} |")
    for occ in sorted(res):
        if "muts" in res[occ]:
            for order, (d, s, mg) in res[occ]["muts"].items():
                print(f"# occ {occ:.1f} oracle-{order}: {d} dynamic "
                      f"verdicts, {s} splits, {mg} merges (in-loop "
                      f"mutations exercised)")
    # trend verdict: does ANY ordering of the in-loop oracle produce a
    # falling RR as occupancy rises (the published trend)?
    occs = sorted(res)
    for m in methods:
        rrs = [res[o][m][1] for o in occs]
        trend = ("falling" if rrs[-1] < rrs[0] - 1e-6 else
                 "non-falling")
        print(f"# {m}: RR {' -> '.join(f'{r:.2f}' for r in rrs)}  "
              f"[{trend}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
