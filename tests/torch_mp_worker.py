"""Rank worker of tests/test_torch_parallel.py and
tests/test_torch_parallel_pgo.py (not collected: no test_ prefix).

`spawn_world` starts `world` processes with the "spawn" context; each joins
a gloo group through a file store and runs `run`: it reads the inputs the
test wrote (`inputs.npz`), calls the port's parallel functions as a user
would on every rank, and writes what it got to `rank<r>.npz`. A rank that
fails writes its traceback to `rank<r>.err`. The worker imports torch,
numpy and the port only.
"""

from __future__ import annotations

import datetime
import multiprocessing
import traceback
from pathlib import Path

import numpy as np


def _window(inp):
    import torch
    return tuple(torch.from_numpy(inp[k]) for k in ("xyz", "intensity",
                                                   "valid", "poses"))


def _graph(inp, prefix):
    import torch
    from dr_using_scv_od_tpu_torch.models import posegraph
    return posegraph.PoseGraph(*(torch.from_numpy(inp[f"{prefix}_{k}"])
                                 for k in ("poses", "edge_i", "edge_j",
                                           "edge_T", "edge_w")))


def _job_sharded(inp, world):
    from dr_using_scv_od_tpu_torch import config
    from dr_using_scv_od_tpu_torch.parallel import sharded_pipeline
    removed, states, n_dyn = sharded_pipeline.sharded_run_window(
        *_window(inp), config.tiny_test())
    return {"removed": removed, "states": states, "n_dynamic": n_dyn}


def _job_tp(inp, world):
    import torch
    from dr_using_scv_od_tpu_torch import config
    from dr_using_scv_od_tpu_torch.parallel import tensor_parallel
    xyz, inten, valid, _ = _window(inp)
    vg = tensor_parallel.tp_voxel_stats(xyz[0], inten[0], valid[0],
                                        config.tiny_test().grid)
    assert vg.count.dtype == torch.int32
    return {"tp_count": vg.count, "tp_mean": vg.intensity_mean,
            "tp_var": vg.intensity_var}


def _job_pp(inp, world):
    from dr_using_scv_od_tpu_torch import config
    from dr_using_scv_od_tpu_torch.parallel import pipeline_parallel as pp
    xyz, inten, valid, _ = _window(inp)
    F = int(inp["pp_frames"])
    got = pp.pipelined_process_window(xyz[:F], inten[:F], valid[:F],
                                      config.tiny_test(),
                                      n_stages=int(inp["pp_stages"]))
    return {"pp_point_voxel": got.point_voxel,
            "pp_point_cluster": got.point_cluster,
            "pp_label_grid": got.label_grid,
            "pp_valid": got.table.valid, "pp_type": got.table.type,
            "pp_n_points": got.table.n_points,
            "pp_bbox_min": got.table.bbox_min,
            "pp_n_clusters": got.n_clusters, "pp_area": got.feats.area}


def _job_scaling(inp, world):
    from dr_using_scv_od_tpu_torch import config
    from dr_using_scv_od_tpu_torch.parallel import scaling
    rows = scaling.measure_scaling(*_window(inp), config.tiny_test(),
                                   device_counts=[1, world], reps=1)
    return {"scaling": np.array([[r["devices"], r["frames_per_s"],
                                  r["efficiency"]] for r in rows])}


def _job_dryrun(inp, world):
    from dr_using_scv_od_tpu_torch.parallel import dryrun
    dryrun.dryrun_multichip(world)
    return {"dryrun_ok": np.ones(())}


def _job_pgo(inp, world):
    from dr_using_scv_od_tpu_torch.parallel import distributed_pgo
    out = {}
    for name in ("square", "loop"):
        poses, err = distributed_pgo.optimize_distributed(
            _graph(inp, name), gn_iters=int(inp[f"{name}_gn"]),
            cg_iters=int(inp[f"{name}_cg"]))
        out[f"cg_{name}_poses"], out[f"cg_{name}_err"] = poses, err
    return out


def _job_schur(inp, world):
    from dr_using_scv_od_tpu_torch.parallel import schur_pgo
    out = {}
    for name in ("chain", "loop"):
        poses, err = schur_pgo.optimize_schur(_graph(inp, name), gn_iters=8)
        out[f"schur_{name}_poses"], out[f"schur_{name}_err"] = poses, err
    return out


JOBS = {"sharded": _job_sharded, "tp": _job_tp, "pp": _job_pp,
        "scaling": _job_scaling, "dryrun": _job_dryrun, "pgo": _job_pgo,
        "schur": _job_schur}


def run(rank: int, world: int, workdir: str, jobs) -> None:
    import torch
    import torch.distributed as dist
    from dr_using_scv_od_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    work = Path(workdir)
    try:
        mesh.init_group("cpu", rank, world, f"file://{work / 'store'}",
                        timeout=datetime.timedelta(seconds=60))
        inp = dict(np.load(work / "inputs.npz"))
        out = {}
        for job in jobs:
            for k, v in JOBS[job](inp, world).items():
                out[k] = v.numpy() if isinstance(v, torch.Tensor) else v
        np.savez(work / f"rank{rank}.npz", **out)
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(world: int, workdir: Path, jobs, inputs: dict,
                timeout: float) -> list:
    """Run `jobs` on a gloo world of `world` spawned ranks; returns each
    rank's results. Fails (after terminating every rank) if a rank fails
    or the world outlives `timeout` seconds."""
    workdir.mkdir(parents=True, exist_ok=True)
    np.savez(workdir / "inputs.npz", **inputs)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, world, str(workdir), jobs))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    for p in procs:
        p.join(max(0.0, (deadline - datetime.datetime.now())
                   .total_seconds()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    errs = {r: (workdir / f"rank{r}.err").read_text()
            for r in range(world) if (workdir / f"rank{r}.err").exists()}
    if hung or errs or any(p.exitcode != 0 for p in procs):
        raise AssertionError(
            f"world of {world}: ranks {hung} still running after "
            f"{timeout} s, exit codes {[p.exitcode for p in procs]}\n"
            + "\n".join(f"--- rank {r}\n{e}" for r, e in errs.items()))
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(world)]
