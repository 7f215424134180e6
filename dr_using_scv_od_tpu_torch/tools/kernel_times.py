"""Device time, wall time and bound of the port's three label kernels on
the frame-0 grid of the 5-frame synthetic window, at config.semantickitti()
width, on one CUDA card.

    python -m dr_using_scv_od_tpu_torch.tools.kernel_times \
        [--baseline DIR] [--reps 20]

It prints how the frame's occupied voxels fall on the tile plan of the
tiled kernels (ops/tile_plan.py): tiles, occupied tiles, the occupied
voxels of the densest tile, and the share of the union graph's edges that
cross a tile border. For each kernel it prints:
  * device ms per call: the sum of the durations of the CUDA kernels one
    wrapper call launches, from torch.profiler's key_averages() over
    `reps` calls, split by CUDA kernel name;
  * graph ms per call: CUDA events around the replay of a CUDA graph that
    holds `reps` calls (device time plus the gaps between the launches);
  * wall ms per call: CUDA events around `reps` back-to-back wrapper calls,
    as chip_smoke.py times them (the host's cost shows here when it is
    larger than the device's);
  * host ms per call: the host clock around `reps` wrapper calls that do
    not wait for the device (the wrapper's Python, allocation and launch
    cost);
  * the bound: the bytes the function must move (`bound_bytes`) over the
    card's 3.35 TB/s, and the device time's share of it.

Beside kernel 2 it times `cluster_labels(occ, enable_shell=False)`, the
same function on kernel 1's tiled passes at radius 1 ("cluster_labels_r1"),
which kernel 2 must not be slower than.

--baseline DIR times, beside the package's kernels and on the same grid,
an older version of them: whichever of cluster_labels.cu, cc_labels.cu and
ri3_labels.cu DIR holds (with their headers), built with the package's nvcc
flags into build/baseline/ and called through their C entries. An entry is
either the package's present, tiled one (a `flag` scratch pointer after the
outputs and the tile plan's TA, TR, TS, threads, tile_smem, seam_smem
before the stream) or the untiled one of the first kernels (one thread per
voxel: init / hook / compress):
  cluster_labels_launch(occ, mean, var, label, A, R, S, radius, cov, diff,
                        far_bin, stream)
  cc_labels_launch(occ, label, A, R, S, stream)
  ri3_labels_launch(root, count, mean, var, label, slot, A, R, S, radius,
                    cov, diff, far_bin, stream)
Which one a source has is read from its text (`tile_smem` in it or not).
The two versions are timed in turns (baseline, package, package,
baseline) and each must give the plain version's labels. The baseline
sources are not part of the package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Tuple

import torch

from .. import config, interop
from ..models import pipeline
from ..ops import cc_labels, cluster_labels, clustering, cuda_build
from ..ops import ri3_labels, tile_plan
from ..utils import synthetic

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
F_WINDOW = 5                  # chip_smoke.py's checked window


def bound_bytes(name: str, G: int, M: int) -> int:
    """The bytes kernel `name` must move on a grid of G voxels with M
    occupied: each input read once where the function needs it (the
    intensity planes and input labels only at occupied voxels), each
    output written once."""
    if name == "cluster_labels":    # occupancy, mean + var, labels out
        return G * 1 + M * 8 + G * 4
    if name in ("cc_labels", "cluster_labels_r1"):   # occupancy, labels out
        return G * 1 + G * 4
    if name == "ri3_labels":        # counts, labels in, mean + var, out
        return G * 4 + M * 4 + M * 8 + G * 4
    raise ValueError(name)


def bound_ms(name: str, G: int, M: int) -> float:
    return bound_bytes(name, G, M) / HBM_BYTES_PER_S * 1e3


def device_ms(fn: Callable[[], object], reps: int
              ) -> Tuple[float, Dict[str, float]]:
    """(device ms per call, {CUDA kernel name: ms per call}) of `fn`, from
    torch.profiler over `reps` calls after one warm-up call. Raises if the
    profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and us > 0:
            split[e.key] = split.get(e.key, 0.0) + us / 1e3 / reps
    if not split:
        raise RuntimeError("torch.profiler recorded no device time")
    return sum(split.values()), split


def short_name(kernel: str) -> str:
    """A CUDA kernel's function name without namespace, template arguments
    and parameters ("tile_pass_kernel")."""
    name = kernel.replace("(anonymous namespace)::", "").split("(")[0]
    return name.split("<")[0].split()[-1]


def graph_ms(fn: Callable[[], object], reps: int, replays: int = 5) -> float:
    """ms per call of `fn` from CUDA events around replays of one CUDA
    graph that holds `reps` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def wall_ms(fn: Callable[[], object], reps: int) -> float:
    """ms per call from CUDA events around `reps` back-to-back calls."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn: Callable[[], object], reps: int) -> float:
    """ms per call on the host clock, the device left to run behind."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def frame0_inputs(device: torch.device):
    """The frame-0 grid of chip_smoke.py's 5-frame window, from the port's
    run_window on `device`: (cfg, occ3, count, mean, var, cc root labels)."""
    cfg = config.semantickitti()
    win = synthetic.render_window(synthetic.make_scene(), F_WINDOW,
                                  cfg.shapes.max_points)
    res = pipeline.run_window(*interop.window_from_numpy(win, device), cfg)
    grid = res.frames.state.grid
    count = grid.count[0].contiguous()
    occ3 = (count > 0).reshape(cfg.grid.shape)
    return (cfg, occ3, count, grid.intensity_mean[0].contiguous(),
            grid.intensity_var[0].contiguous(),
            clustering.connected_components(occ3))


def tile_stats(occ3: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               cfg) -> Dict[str, float]:
    """How the occupied voxels fall on the tile plan of the frame's grid."""
    seg = cfg.seg
    radius = cluster_labels.shell_radius(seg.search_c, True)
    p = tile_plan.plan(tuple(occ3.shape), radius)
    A, R, S = occ3.shape
    ids, src, dst = cluster_labels.union_graph_edges(
        occ3, mean, var, radius, seg.intensity_cov, seg.intensity_diff,
        seg.far_range_frac)
    TA, TR, TS = p.tile
    _, ntr, nts = p.counts
    tile = ((ids // (R * S) // TA) * ntr + (ids // S) % R // TR) * nts \
        + ids % S // TS
    per_tile = torch.bincount(tile, minlength=p.n_tiles)
    d = torch.stack([dst // (R * S) - src // (R * S),
                     (dst // S) % R - (src // S) % R, dst % S - src % S], 1)
    seam = tile_plan.seam_pass_takes(p, src, d)
    return {"tile": p.tile, "tiles": p.n_tiles,
            "occupied_tiles": int((per_tile > 0).sum()),
            "densest_tile": int(per_tile.max()), "edges": int(src.numel()),
            "seam_edges": int(seam.sum())}


def _baseline_calls(directory: Path, cfg, occ3, count, mean, var, root):
    """The label kernels whose sources `directory` holds, as {name: fn() ->
    labels}: each `<name>.cu` built with the package's nvcc flags and called
    through its C entry, tiled (the package's present entry) where the
    source's entry takes `tile_smem`, else untiled."""
    A, R, S = cfg.grid.shape
    G = A * R * S
    seg = cfg.seg
    radius = cluster_labels.shell_radius(seg.search_c, True)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    gate = (radius, seg.intensity_cov, seg.intensity_diff,
            int(R * seg.far_range_frac))
    gate_types = (ci, cf, cf, ci)
    # name: (inputs, outputs, scalars after A, R, S, their types, tile plan)
    specs = {
        "cluster_labels": ((occ3, mean, var), 1, gate, gate_types,
                           tile_plan.plan((A, R, S), radius)),
        "cc_labels": ((occ3,), 1, (), (), tile_plan.plan((A, R, S), 1)),
        "ri3_labels": ((root, count, mean, var), 2, gate, gate_types,
                       tile_plan.plan((A, R, S), radius, min_label=True)),
    }
    names = [n for n in specs if (directory / f"{n}.cu").exists()]
    if not names:
        raise SystemExit(f"kernel_times: no kernel source in {directory}")
    out_dir = cuda_build.BUILD_DIR / "baseline"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.nvcc_path()
    procs = {name: subprocess.Popen(
        [nvcc, *cuda_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"),
         str(directory / f"{name}.cu")], stderr=subprocess.PIPE, text=True)
        for name in names}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {directory / name}.cu:\n{err}")

    def call(name):
        inputs, n_out, scalars, scalar_types, plan = specs[name]
        tiled = "tile_smem" in (directory / f"{name}.cu").read_text()
        fn = getattr(ctypes.CDLL(str(out_dir / f"lib{name}.so")),
                     f"{name}_launch")
        fn.argtypes = [*(vp,) * (len(inputs) + n_out + tiled), ci, ci, ci,
                       *scalar_types, *(ci,) * (6 * tiled), vp]
        fn.restype = ci
        tail = plan.kernel_args if tiled else ()
        print(f"baseline {name}: {'tiled' if tiled else 'untiled'} entry",
              flush=True)

        def run():
            bufs = [torch.empty(G, dtype=torch.int32, device=occ3.device)
                    for _ in range(n_out)]
            if tiled:       # the flag scratch, one word a tile
                bufs.append(torch.empty(plan.n_tiles, dtype=torch.int32,
                                        device=occ3.device))
            err = fn(*(t.data_ptr() for t in (*inputs, *bufs)), A, R, S,
                     *scalars, *tail,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"baseline {name} failed: CUDA error "
                                   f"{err}")
            return bufs[0]
        return run

    return {name: call(name) for name in names}


def measure(fn, reps: int) -> Dict[str, object]:
    dev, split = device_ms(fn, reps)
    return {"device_ms": dev, "split_ms": split,
            "graph_ms": graph_ms(fn, reps), "wall_ms": wall_ms(fn, reps),
            "host_ms": host_ms(fn, reps)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="csrc directory of an older version of the "
                         "kernels to time beside the package's")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"gpu: {smi}", flush=True)
    cuda_build.build_libraries("cluster_labels", "cc_labels", "ri3_labels")
    cfg, occ3, count, mean, var, root = frame0_inputs(dev)
    A, R, S = cfg.grid.shape
    G, M = A * R * S, int(count.gt(0).sum())
    seg = cfg.seg
    gate = (seg.search_c, seg.intensity_cov, seg.intensity_diff,
            seg.far_range_frac)
    print(f"frame-0 grid {A} x {R} x {S}: G = {G}, M = {M}", flush=True)
    stats = tile_stats(occ3, mean, var, cfg)
    print(f"tile plan: {stats}", flush=True)
    current = {
        "cluster_labels": lambda: cluster_labels.cluster_labels(
            occ3, mean, var, *gate),
        "cc_labels": lambda: cc_labels.cc_labels(occ3),
        "cluster_labels_r1": lambda: cluster_labels.cluster_labels(
            occ3, mean, var, *gate, enable_shell=False),
        "ri3_labels": lambda: ri3_labels.ri3_labels(
            root, count, mean, var, (A, R, S), *gate),
    }
    plain = {
        "cluster_labels": lambda: cluster_labels.cluster_labels_reference(
            occ3, mean, var, *gate),
        "cc_labels": lambda: clustering.connected_components(occ3),
        "cluster_labels_r1": lambda: clustering.connected_components(occ3),
        "ri3_labels": lambda: ri3_labels.ri3_labels_reference(
            root, count, mean, var, (A, R, S), *gate),
    }
    versions = {"package": current}
    order = ["package"]
    if args.baseline is not None:
        versions["baseline"] = _baseline_calls(
            args.baseline, cfg, occ3, count, mean, var, root)
        order = ["baseline", "package", "package", "baseline"]
    for name in current:
        want = plain[name]()
        for version in versions.values():
            if name in version and not torch.equal(version[name](), want):
                raise RuntimeError(f"{name}: labels differ from the plain "
                                   f"version")
    results = {}
    for version in order:
        for name, fn in versions[version].items():
            r = measure(fn, args.reps)
            r["bound_ms"] = bound_ms(name, G, M)
            r["share_of_bound"] = r["bound_ms"] / r["device_ms"]
            results.setdefault(version, {}).setdefault(name, []).append(r)
            print(f"{version:<8} {name:<17} device {r['device_ms']:.4f} ms "
                  f"graph {r['graph_ms']:.4f} wall {r['wall_ms']:.4f} "
                  f"host {r['host_ms']:.4f} "
                  f"bound {r['bound_ms'] * 1e3:.3f} us share "
                  f"{100 * r['share_of_bound']:.2f} %", flush=True)
            for k, v in sorted(r["split_ms"].items(), key=lambda x: -x[1]):
                print(f"{'':<25} {v * 1e3:9.3f} us  {short_name(k)}",
                      flush=True)
    print(json.dumps({"gpu": smi, "G": G, "M": M, "tiles": stats,
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
