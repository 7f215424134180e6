"""The port's end-to-end drive (dr_using_scv_od_tpu_torch/tools/
drive_e2e.py) against the JAX tool (tools/drive_e2e.py) on the CPU: the
4-frame window at the full semantickitti() width. Tolerance: none, the
printed lines (patchwork recall / precision, clusters per frame, dynamic
verdicts, PR / RR / F1 to the digits printed) are identical."""

import contextlib
import io

from tools import drive_e2e as jdrive
from dr_using_scv_od_tpu_torch.tools import drive_e2e


def test_drive_e2e_prints_the_jax_lines():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jdrive.main()
    want = buf.getvalue().splitlines()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert drive_e2e.main(["--device", "cpu"]) == 0
    assert buf.getvalue().splitlines() == want
    assert want[-1] == "E2E DRIVE OK"
