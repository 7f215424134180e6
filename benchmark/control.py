"""Readings that the limits of `correct` are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--out control.jsonl]

For each seed, in one process: the cell's set-up, then one pass of its
traffic through the port (the removal pool once, one SLAM session) and
the plain reference over the same inputs, and each compared number's
reading (the lower readings: the program's sound runs). For the seeds of
--control-seeds also the control: the reference put in the program's place
and run one step below the float32 the configurations state (the cell's
`control`, or --mode; harness.CONTROLS): the upper readings. One JSON line per seed on
stdout (and appended to --out). Not part of any benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def readings(cell: str, seed: int, mode: str, device):
    wl = harness.workload(cell)
    driver = harness.load_module("drivers", wl["driver"])
    harness.set_float32_matmul(False)
    state = driver.setup(harness.config_doc(wl["config"]), wl["traffic"],
                         seed, device)
    t0 = time.perf_counter()
    program, control = driver.control(state, mode)
    return {"cell": cell, "seed": seed, "program": program,
            "control": control, "mode": mode, "limits": wl["limits"],
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--mode", default="",
                    help="the control (harness.CONTROLS); default: the "
                         "cell's own, its file's `control`")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    mode = args.mode or harness.workload(args.workload)["control"]
    for seed in [int(s) for s in args.seeds.split(",")]:
        line = json.dumps(readings(args.workload, seed,
                                   mode if seed in ctl else "", device))
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
