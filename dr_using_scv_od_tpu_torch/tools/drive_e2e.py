"""End-to-end synthetic drive of the port (counterpart of
tools/drive_e2e.py): render a labelled 4-frame window at the
semantickitti() width, run the full removal pipeline, and report patchwork
quality, clusters per frame, dynamic verdicts and PR / RR / F1.

    python -m dr_using_scv_od_tpu_torch.tools.drive_e2e [--device cuda]

It raises (exit code 1) below the JAX tool's floors: patchwork recall
0.85 / precision 0.95 on frame 0, PR 95 / RR 80 on the judged frames.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import config, interop
from ..eval import metrics
from ..models import patchwork, pipeline
from ..utils import synthetic
from .profile_stages import require_device

F = 4


def drive(device: torch.device | str):
    """Run the drive on `device`; returns (printed lines, patchwork
    (recall, precision), RemovalMetrics of the judged frames). Raises if
    the device is missing."""
    device = require_device(device)
    cfg = config.semantickitti()
    win = synthetic.render_window(synthetic.make_scene(), F,
                                  cfg.shapes.max_points)
    xyz, inten, valid, poses = interop.window_from_numpy(win, device)
    labels = win["label"]

    pw = patchwork.estimate_ground(xyz[0], valid[0], cfg.patchwork)
    g = pw.ground.cpu().numpy()
    is_gnd = (labels[0] == 40) & win["valid"][0]
    recall = (g & is_gnd).sum() / max(is_gnd.sum(), 1)
    prec = (g & is_gnd).sum() / max(g.sum(), 1)

    res = pipeline.run_window(xyz, inten, valid, poses, cfg)
    m = metrics.removal_metrics(labels[:F - 1].reshape(-1),
                                res.removed[:F - 1].cpu().numpy().reshape(-1),
                                win["valid"][:F - 1].reshape(-1))
    lines = [f"patchwork: recall={recall:.3f} precision={prec:.3f}",
             f"n_clusters/frame: {res.frames.n_clusters.cpu().numpy()}",
             f"n_dynamic verdicts: {res.n_dynamic.cpu().numpy()}",
             f"PR={m.pr:.2f} RR={m.rr:.2f} F1={m.f1:.4f}"]
    return lines, (recall, prec), m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    lines, (recall, prec), m = drive(args.device)
    print("\n".join(lines[:1]), flush=True)
    assert recall > 0.85 and prec > 0.95, "patchwork quality floor"
    print("\n".join(lines[1:]), flush=True)
    assert m.pr > 95.0 and m.rr > 80.0, "pipeline accuracy floor"
    print("E2E DRIVE OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
