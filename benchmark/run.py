"""Run one cell of the port's benchmark once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(or `python3 -m benchmark.run ...` from the repo's root). The cell is
`benchmark/workloads/<cell>.json`; its configuration, driver, traffic and
per-layer metrics are found by the names it and BENCHMARK.json give.

The run sets up (builds the kernels if they are not built yet, renders
the traffic from --seed, uploads it and warms every shape the cell uses:
`setup_s`, from the start of this process), then measures for --seconds:
with --trace 0 the cell's end-to-end metrics; with --trace 1 a profiled
stretch and a stretch of synchronised spans that its per-layer metrics
read. Then, with the window closed and the peak memory read, it compares
what the timed path produced with the plain reference
(`benchmark/reference/`), prints each compared number beside its limit as
the last lines of stderr, and prints one JSON line on stdout: correct,
attempted, failed, metrics, device, (breakdown,) checks.

It exits 1 and prints no result without a CUDA card (or with fewer than
the cell asks for), and when a module of jax, jaxlib, flax or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()     # setup_s counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

if __package__ in (None, ""):     # run as a script: the repo root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def err(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             chips: int = 1, t_start: Optional[float] = None
             ) -> Dict[str, Any]:
    """One run of `cell` on `device`; returns the result line's object.
    Raises RuntimeError where a forbidden module is loaded after the
    window. The CPU serves the harness's own tests at tiny sizes."""
    spec = harness.benchmark_spec()
    wl = harness.workload(cell)
    if wl["traffic"]["name"] != harness.cell_entry(spec, cell)["traffic"]:
        raise ValueError(f"{cell}: traffic name differs from BENCHMARK.json")
    doc = harness.config_doc(wl["config"])
    driver = harness.load_module("drivers", wl["driver"])
    harness.set_float32_matmul(False)

    with harness.stage("setup"):
        state = driver.setup(doc, wl["traffic"], seed, device)
        harness.sync(device)
    setup_s = time.perf_counter() - (T_START if t_start is None else t_start)

    spans = None
    with harness.stage("window"):
        if trace:
            answers, tr, spans, ctx = driver.traced(state)
        else:
            answers, e2e = driver.window(state, seconds)
    found = harness.forbidden_modules()
    if found:
        raise RuntimeError("forbidden modules loaded: " + ", ".join(found))
    dev = harness.device_block(device, chips)

    with harness.stage("check"):
        checks, attempted, failed, extra = driver.check(state, answers,
                                                        wl["limits"])
    units = harness.units(spec)
    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        ctx.update(extra)
        ctx["trace"] = tr
        for name in harness.per_layer_names(spec, cell):
            value = harness.load_module("metrics", name).read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    else:
        e2e["setup_s"] = setup_s
        for name in harness.end_to_end_names(spec, cell):
            metrics[name] = {"value": e2e[name], "unit": units[name]}
    result: Dict[str, Any] = {
        "correct": harness.passes(checks), "attempted": attempted,
        "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = harness.breakdown(tr, spans)
    result["checks"] = harness.checks_block(checks)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = harness.benchmark_spec()
    chips = harness.cell_entry(spec, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        err(f"no result: the cell needs {chips} CUDA card(s), "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " visible")
        return 1
    device = torch.device("cuda", 0)
    # the served path is one host thread launching kernels; intra-op
    # threads on the host would only contend with it
    torch.set_num_threads(1)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), device, chips)
    except RuntimeError as e:
        if "forbidden modules" not in str(e):
            raise
        err(f"no result: {e}")
        return 1
    for name, c in result["checks"].items():
        err(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
